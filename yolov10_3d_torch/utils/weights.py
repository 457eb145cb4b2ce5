"""JAX parameter tree <-> the port's state_dict (the port's own copy of
``yolov10_3d_tpu/utils/torch_export.py`` ``flax_to_torch_state_dict``, cut
to the YOLOv10, YOLOv10-3D and YOLOv8 families, its inverse
``torch_to_flax_variables`` for the checkpoints both packages read, and
``graft_backbone``, the copy of ``utils/torch_convert.py``'s on the port's
state_dict).

Input: the flax ``{'params', 'batch_stats'}`` tree as nested mappings of
numpy arrays (or anything ``np.asarray`` takes). A flax path joined with
``_`` is the torch dotted path with ``.`` -> ``_``; the split back is
ambiguous only for attribute names that contain underscores, which are
re-merged against ``_ATOMS`` per path segment.

Layouts: kernel (kH, kW, I/g, O) -> weight (O, I/g, kH, kW) (the same
transpose takes ``Proto``'s transposed-conv kernel, flax's (kH, kW, O, I)
under ``transpose_kernel=True``, to torch's (I, O, kH, kW), with no spatial
flip: ``tests/test_torch_v8_heads.py`` holds ``Proto`` alone to JAX); BN and GroupNorm
scale/bias -> weight/bias; batch_stats mean/var -> running_mean/running_var, plus
``num_batches_tracked``. The DFL decode has no parameters in the port, so no
``dfl.conv.weight`` is emitted. The 3D head's one-to-one branches are the
attributes ``cls`` ... ``dep_un`` and its one-to-many ones ``o2m_heads.{j}``;
the port registers each module once, so the ``o2o_heads.{j}`` alias keys of
the reference's state_dict are not emitted either.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

# attribute names with underscores in the v10 and v10-3D modules (then the
# 3D head's DepthPredictor and its DeformableConv2d). The JAX package's own
# .pt export (utils/torch_export.py:38) lacks "modulator_conv" and so writes
# "modulator.conv"; the port keeps the reference's name, which the
# reference's DeformableConv2d state_dict carries (engine/model.py maps the
# JAX export's spelling when it loads a .pt).
_ATOMS = {"one2one_cv2", "one2one_cv3", "dep_un", "o2m_heads", "fgdm_predictor", "depth_head",
          "depth_classifier", "offset_conv", "modulator_conv", "regular_conv"}
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


def _flax_segments(dotted: str) -> List[str]:
    """Dotted torch path -> flax path segments: each index joins the name
    before it (``model.2.m.0`` -> ``model_2``, ``m_0``), as flax names the
    members of a list attribute."""
    segs: List[str] = []
    for tok in dotted.split("."):
        if tok.isdigit() and segs:
            segs[-1] = f"{segs[-1]}_{tok}"
        else:
            segs.append(tok)
    return segs


def torch_to_flax_variables(state_dict: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """The port's state_dict -> the flax ``{'params', 'batch_stats'}`` tree
    the JAX package builds for the same model, as nested dicts of the same
    leaves (tensors stay tensors, on their device; anything else becomes a
    numpy array): weight (O, I/g, kH, kW) -> kernel (kH, kW, I/g, O) (a
    permuted view), BN and GroupNorm weight/bias -> scale/bias, running
    mean/var -> batch_stats mean/var; ``num_batches_tracked`` is dropped.
    The inverse of ``flax_to_torch_state_dict``."""
    out: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for key, value in state_dict.items():
        prefix, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        w = value.detach() if isinstance(value, torch.Tensor) else np.asarray(value)
        if leaf in ("running_mean", "running_var"):
            coll, name = "batch_stats", {"running_mean": "mean", "running_var": "var"}[leaf]
        elif leaf == "weight":
            coll = "params"
            if w.ndim == 1:  # BatchNorm and GroupNorm
                name = "scale"
            elif w.ndim == 4:
                name = "kernel"
                w = (w.permute(2, 3, 1, 0) if isinstance(w, torch.Tensor)
                     else w.transpose(2, 3, 1, 0))
            else:
                raise ValueError(f"{key}: no flax leaf for a weight of shape {w.shape}")
        elif leaf == "bias":
            coll, name = "params", "bias"
        else:
            raise ValueError(f"{key}: no flax leaf for {leaf!r}")
        node = out[coll]
        for seg in _flax_segments(prefix):
            node = node.setdefault(seg, {})
        node[name] = w
    return out


@torch.no_grad()
def graft_backbone(model: torch.nn.Module, source: Mapping[str, Any], head_index: int
                   ) -> List[str]:
    """Copy into ``model`` every entry of the ``source`` state_dict that lies
    outside layer ``head_index`` and matches a parameter or BN statistic of
    ``model`` by name and shape (the JAX ``utils/torch_convert.py``
    ``graft_backbone``: a pretrained 2D backbone in a new 3D model); the rest
    keeps its init. Returns the copied keys."""
    head = f"model.{head_index}."
    copied = []
    for key, dst in model.state_dict().items():
        if key.startswith(head) or key.endswith("num_batches_tracked") or key not in source:
            continue
        src = torch.as_tensor(source[key])
        if tuple(src.shape) == tuple(dst.shape):
            dst.copy_(src)
            copied.append(key)
    return copied
