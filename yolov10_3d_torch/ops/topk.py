"""Top-k with ``jax.lax.top_k``'s tie order.

``torch.topk`` leaves the order of equal values to the backend (its CPU
and CUDA paths return different indices for the same tied input), while
``jax.lax.top_k`` gives ties to the lowest index. Ties are common in
serving: float32 sigmoids saturate at 1.0, and letterbox padding gives
identical logits. Every top-k of the port goes through
``topk_lowest_index``, so the detections kept at the ``max_det`` cut, and
the sparse 3D head's candidates, are the JAX package's.
"""

from __future__ import annotations

from typing import Tuple

import torch


def topk_lowest_index(x: torch.Tensor, k: int, dim: int = -1
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values of ``x`` along ``dim`` and their indices, in
    descending order; among equal values the lowest index comes first. A
    stable descending sort cut to ``k``: the same code on CPU and CUDA."""
    values, indices = torch.sort(x, dim=dim, descending=True, stable=True)
    return values.narrow(dim, 0, k), indices.narrow(dim, 0, k)
