"""JAX parameter tree -> the port's state_dict (the port's own copy of
``yolov10_3d_tpu/utils/torch_export.py`` ``flax_to_torch_state_dict``, cut
to the YOLOv10 and YOLOv10-3D families).

Input: the flax ``{'params', 'batch_stats'}`` tree as nested mappings of
numpy arrays (or anything ``np.asarray`` takes). A flax path joined with
``_`` is the torch dotted path with ``.`` -> ``_``; the split back is
ambiguous only for attribute names that contain underscores, which are
re-merged against ``_ATOMS`` per path segment.

Layouts: kernel (kH, kW, I/g, O) -> weight (O, I/g, kH, kW); BN and GroupNorm
scale/bias -> weight/bias; batch_stats mean/var -> running_mean/running_var, plus
``num_batches_tracked``. The DFL decode has no parameters in the port, so no
``dfl.conv.weight`` is emitted. The 3D head's one-to-one branches are the
attributes ``cls`` ... ``dep_un`` and its one-to-many ones ``o2m_heads.{j}``;
the port registers each module once, so the ``o2o_heads.{j}`` alias keys of
the reference's state_dict are not emitted either.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

# attribute names with underscores in the v10 and v10-3D modules (the last
# three: the 3D head's DepthPredictor)
_ATOMS = {"one2one_cv2", "one2one_cv3", "dep_un", "o2m_heads", "fgdm_predictor", "depth_head",
          "depth_classifier"}
_ATOM_TOKENS = sorted({tuple(a.split("_")) for a in _ATOMS}, key=len, reverse=True)


def _dotted(segments) -> str:
    """Flax path segments -> dotted torch path (``model_0`` -> ``model.0``)."""
    out = []
    for seg in segments:
        tokens = seg.split("_")
        i = 0
        while i < len(tokens):
            for atom in _ATOM_TOKENS:
                if tuple(tokens[i : i + len(atom)]) == atom:
                    out.append("_".join(atom))
                    i += len(atom)
                    break
            else:
                out.append(tokens[i])
                i += 1
    return ".".join(out)


def flax_to_torch_state_dict(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Convert a flax ``{'params', 'batch_stats'}`` tree to the port's
    state_dict, as numpy arrays."""
    sd: Dict[str, np.ndarray] = {}

    def emit_params(tree, tokens):
        if not isinstance(tree, Mapping):
            leaf, prefix = tokens[-1], _dotted(tokens[:-1])
            w = np.asarray(tree)
            if leaf == "kernel":
                if w.ndim != 4:
                    raise ValueError(f"{prefix}: expected a conv kernel, got shape {w.shape}")
                sd[f"{prefix}.weight"] = w.transpose(3, 2, 0, 1)
            elif leaf == "scale":
                sd[f"{prefix}.weight"] = w
            else:  # bias
                sd[f"{prefix}.{leaf}"] = w
            return
        for k, v in tree.items():
            emit_params(v, tokens + [k])

    def emit_stats(tree, tokens):
        if not isinstance(tree, Mapping):
            leaf, prefix = tokens[-1], _dotted(tokens[:-1])
            name = {"mean": "running_mean", "var": "running_var"}[leaf]
            sd[f"{prefix}.{name}"] = np.asarray(tree)
            sd.setdefault(f"{prefix}.num_batches_tracked", np.zeros((), np.int64))
            return
        for k, v in tree.items():
            emit_stats(v, tokens + [k])

    emit_params(variables.get("params", {}), [])
    emit_stats(variables.get("batch_stats", {}), [])
    return sd


def load_flax_variables(module: torch.nn.Module, variables: Mapping[str, Any]) -> torch.nn.Module:
    """Convert ``variables`` and load them into ``module`` with strict=True."""
    sd = flax_to_torch_state_dict(variables)
    module.load_state_dict(
        {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}, strict=True
    )
    return module
