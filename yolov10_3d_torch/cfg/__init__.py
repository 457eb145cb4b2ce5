"""Configuration: the model YAMLs, dataset YAMLs and the defaults the port reads.

The model YAMLs under ``models/v10`` and ``models/v10-3D`` are copies of the
JAX package's. The machines the port runs on need not have PyYAML, so
``load_yaml`` reads the small subset those files and dataset YAMLs use:
top-level scalars, flow mappings of scalars (the 3D head's ``channels``),
one level of nested mapping (``scales``, ``names``) and block sequences of
scalars or flow lists (``backbone``/``head``).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

CFG_DIR = Path(__file__).resolve().parent

# Every key of the JAX package's cfg/default.yaml, with its value after JAX's
# coercion (get_cfg().to_dict()), copied here so that the card needs no
# PyYAML; and the port's own ``stream``. A key is accepted wherever JAX
# accepts it. The engine reads the keys it has ported; a path that needs a
# key's behaviour the port lacks refuses on its own: the port builds the
# detection heads only, so the classify and pose keys (crop_fraction, kobj,
# pose) have no path to reach (ROADMAP item 13, other heads and tasks); live
# sources raise naming item 22c (stream_buffer and vid_stride act on video
# files' streams, data/loaders.py); the 2D trainer raises on the
# training options it has not ported (engine/trainer.py). Keys no JAX engine
# path reads (half, save_conf, plots, project, ...) are accepted and do
# nothing, as in JAX. spd_serving (on, as in the JAX package)
# serves layer 0 through the fused stem kernel (nn/modules.py
# Conv.fused_stem); the 3D trainer runs every 3D key, the distillation and
# DINOv2 teacher keys included (engine/trainer3d.py, models/dino.py).
DEFAULTS: Dict[str, Any] = {
    # task and mode
    "task": "detect",
    "mode": "train",
    # train
    "model": None,
    "data": None,
    "epochs": 400,
    "time": None,
    "patience": 150,
    "batch": 32,
    "imgsz": [960, 640],
    "save": True,
    "save_period": -1,
    "ckpt_period_steps": 0,
    "val_period": 1,
    "cache": False,
    "device": None,
    "workers": 4,
    "project": None,
    "name": None,
    "exist_ok": False,
    "pretrained": True,
    "optimizer": "AdamW",
    "verbose": True,
    "seed": 5,
    "deterministic": True,
    "single_cls": False,
    "rect": False,
    "cos_lr": False,
    "close_mosaic": 10,
    "resume": False,
    "device_preprocess": True,  # same-shape uint8 chunks letterboxed on the device
    "spd_serving": True,
    "device_aug": False,
    "amp": True,
    "fraction": 1.0,
    "profile": False,
    "freeze": None,
    "multi_scale": False,
    "overlap_mask": True,
    "mask_ratio": 4,
    "dropout": 0.0,
    "pretrained_backbone": True,
    # val / test
    "val": True,
    "split": "val",
    "save_json": False,
    "save_hybrid": False,
    "conf": None,
    "iou": 0.7,
    "max_det": 50,
    "half": False,
    "dnn": False,
    "plot_labels": False,
    "plots": False,
    # predict
    "source": None,
    "stream": False,  # the port's own: predict(stream=True) yields Results
    "vid_stride": 1,
    "stream_buffer": False,
    "visualize": False,
    "augment": False,
    "agnostic_nms": False,
    "classes": None,
    "retina_masks": False,
    "embed": None,
    "use_o2m_depth": False,
    "use_dino_depth": False,
    "dino_path": None,
    # visualize
    "show": False,
    "save_frames": False,
    "save_txt": False,
    "save_conf": False,
    "save_crop": False,
    "show_labels": True,
    "show_conf": True,
    "show_boxes": True,
    "line_width": None,
    # export
    "format": "stablehlo",
    "keras": False,
    "optimize": False,
    "int8": False,
    "dynamic": False,
    "simplify": False,
    "opset": None,
    "workspace": 4,
    "nms": False,
    # optimizer / schedule
    "lr0": 0.001,
    "lrf": 0.01,
    "momentum": 0.937,
    "weight_decay": 0.0005,
    "warmup_epochs": 3.0,
    "warmup_momentum": 0.8,
    "warmup_bias_lr": 0.1,
    # loss gains
    "box": 5.0,
    "cls": 1.0,
    "loss2d": 2.0,
    "depth": 1.0,
    "offset3d": 10.0,
    "size3d": 1.0,
    "heading": 1.0,
    "dfl": 1.5,
    "pose": 12.0,
    "kobj": 1.0,
    "label_smoothing": 0.0,
    "nbs": 64,
    # task-aligned assignment
    "tal_topk": 8,
    "tal_alpha": 0.5,
    "tal_beta": 1.0,
    "tal_gamma": 1.0,
    "tal_3d": True,
    "tal_2d": True,
    "kps_dist_metric": "l1",
    "constrain_anchors": True,
    # 3D training extras
    "htl": False,
    "close_mixup": 0,
    "max_depth_threshold": 120,
    "min_depth_threshold": 1,
    "min_scale": 0.8,
    "max_scale": 1.2,
    "overfit": False,
    "distillation": False,
    "distillation_temp": 2,
    "distillation_weight": 0.75,
    "distillation_loss": "soft",
    "distillation_no_mixup": True,
    "load_depth_maps": False,
    "fgdm_loss": False,
    "fgdm_loss_weight": 2,
    "fgdm_supervision": False,
    "fgdm_supervision_weight": 1,
    # augmentation
    "hsv_h": 0.015,
    "hsv_s": 0.7,
    "hsv_v": 0.4,
    "degrees": 0.0,
    "translate": 0.1,
    "scale": 0.4,
    "shear": 0.0,
    "perspective": 0.0,
    "flipud": 0.0,
    "fliplr": 0.5,
    "random_crop": 0.5,
    "bgr": 0.0,
    "mosaic": 1.0,
    "mosaic9": 0.0,
    "mixup": 0.5,
    "cam_dis": False,
    "kitti_resolution": None,
    "copy_paste": 0.0,  # the segment task's (item 13); detection draws nothing for it
    "auto_augment": "randaugment",
    "erasing": 0.4,
    "crop_fraction": 1.0,
    "cfg": None,
    "tracker": "botsort.yaml",
    "save_dir": None,
    "weights": None,
}

# JAX's typed key groups (yolov10_3d_tpu/cfg/__init__.py), for _coerce
CFG_FLOAT_KEYS = {
    "warmup_epochs", "box", "cls", "dfl", "degrees", "shear", "time",
    "loss2d", "depth", "offset3d", "size3d", "heading",
    "tal_alpha", "tal_beta", "tal_gamma",
}
CFG_FRACTION_KEYS = {
    "dropout", "iou", "lr0", "lrf", "momentum", "weight_decay",
    "warmup_momentum", "warmup_bias_lr", "label_smoothing", "hsv_h", "hsv_s",
    "hsv_v", "translate", "scale", "perspective", "flipud", "fliplr", "bgr",
    "mosaic", "mixup", "copy_paste", "conf", "fraction", "random_crop",
}
CFG_INT_KEYS = {
    "epochs", "patience", "workers", "seed", "close_mosaic",
    "mask_ratio", "max_det", "vid_stride", "line_width", "workspace", "nbs",
    "save_period", "val_period", "ckpt_period_steps", "tal_topk", "close_mixup",
}
CFG_BOOL_KEYS = {
    "save", "exist_ok", "verbose", "deterministic", "single_cls", "rect",
    "cos_lr", "overlap_mask", "val", "save_json", "save_hybrid", "half",
    "dnn", "plots", "show", "save_txt", "save_conf", "save_crop",
    "save_frames", "show_labels", "show_conf", "visualize", "augment",
    "agnostic_nms", "retina_masks", "show_boxes", "keras", "optimize",
    "int8", "dynamic", "simplify", "nms", "profile", "multi_scale", "spd_serving",
    "tal_2d", "tal_3d", "constrain_anchors", "htl", "overfit",
    "distillation", "load_depth_maps", "fgdm_loss", "fgdm_supervision",
    "use_o2m_depth", "use_dino_depth", "plot_labels", "pretrained_backbone",
    "cam_dis", "amp", "stream_buffer", "device_preprocess", "device_aug",
}


_TRUE, _FALSE = ("true", "1", "yes"), ("false", "0", "no")


def _coerce(key: str, v: Any) -> Any:
    """JAX's coercion: int keys to int (not bools), float and fraction keys
    to float, bool keys given as strings by their spelling; None stays. A
    string that spells neither true nor false raises, where JAX reads it as
    False: ``spd_serving="all"`` (a build option's value) must not serve
    silently without the fused stem."""
    if v is None:
        return v
    try:
        if key in CFG_INT_KEYS and not isinstance(v, bool):
            return int(v)
        if key in CFG_FLOAT_KEYS or key in CFG_FRACTION_KEYS:
            return float(v)
        if key in CFG_BOOL_KEYS and isinstance(v, str):
            if v.lower() not in _TRUE + _FALSE:
                raise ValueError(f"not a bool spelling ({'/'.join(_TRUE + _FALSE)})")
            return v.lower() in _TRUE
    except (TypeError, ValueError) as e:
        raise ValueError(f"config key '{key}'={v!r}: {e}") from e
    return v


def get_cfg(overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """DEFAULTS < overrides, coerced as JAX's get_cfg coerces; an unknown key
    raises KeyError, as in JAX, except with the value None, which JAX drops."""
    overrides = {k: v for k, v in (overrides or {}).items() if v is not None or k in DEFAULTS}
    unknown = sorted(set(overrides) - set(DEFAULTS))
    if unknown:
        raise KeyError(f"unknown config keys {unknown}; valid keys: {sorted(DEFAULTS)}")
    return {k: _coerce(k, v) for k, v in {**DEFAULTS, **overrides}.items()}


def load_dataset_yaml(path) -> Dict[str, Any]:
    """Dataset YAML {path, train, val, names (list or index mapping) | nc}
    -> the same dict with ``names`` as {index: name} and ``nc``. A name that
    is not a file is looked up among the port's ``cfg/datasets``."""
    path = Path(path)
    if not path.exists() and (CFG_DIR / "datasets" / path.name).exists():
        path = CFG_DIR / "datasets" / path.name
    if not path.exists():
        raise FileNotFoundError(f"dataset yaml not found: {path}")
    d = load_yaml(path)
    names = d.get("names")
    if isinstance(names, list):
        names = dict(enumerate(names))
    if names is None and "nc" in d:
        names = {i: f"class{i}" for i in range(int(d["nc"]))}
    if not names:
        raise ValueError(f"{path}: dataset yaml needs names or nc")
    d["names"] = {int(k): v for k, v in names.items()}
    d["nc"] = len(d["names"])
    return d


def resolve_model_cfg(name: str) -> Path:
    """'yolov10s.yaml' / 'yolov10s' / a path -> the YAML file. A name is
    looked up by its literal stem, as JAX's ``_resolve_model_cfg`` does: the
    scale comes from a path's stem (``nn/build.py``), so ``yolov8-seg.yaml``
    is the first scale, n, and ``yolov8s-seg.yaml`` exists only as a path."""
    p = Path(name)
    if p.exists():
        return p
    for family in ("v10", "v10-3D", "v8"):
        cand = CFG_DIR / "models" / family / f"{p.stem}.yaml"
        if cand.exists():
            return cand
    raise FileNotFoundError(f"model config not found: {name}")


# ------------------------------------------------------------ YAML subset
_INT = re.compile(r"[-+]?\d+$")
_FLOAT = re.compile(r"[-+]?(\d+\.\d*|\.\d+)([eE][-+]?\d+)?$")


def _scalar(tok: str) -> Any:
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "'\"":
        return tok[1:-1]
    if _INT.match(tok):
        return int(tok)
    if _FLOAT.match(tok):
        return float(tok)
    if tok in ("true", "True", "TRUE"):
        return True
    if tok in ("false", "False", "FALSE"):
        return False
    if tok in ("null", "Null", "NULL", "~", ""):
        return None
    return tok


def _flow(text: str, i: int = 0) -> Tuple[Any, int]:
    """Parse a flow sequence ``[a, [b, c], "d"]`` starting at text[i]."""
    if text[i] != "[":
        raise ValueError(f"expected '[' at {text[i:]!r}")
    out: List[Any] = []
    i += 1
    while True:
        while text[i] == " ":
            i += 1
        if text[i] == "]":
            return out, i + 1
        if text[i] == "[":
            item, i = _flow(text, i)
        else:
            j = i
            if text[i] in "'\"":
                j = text.index(text[i], i + 1) + 1
            while text[j] not in ",]":
                j += 1
            item, i = _scalar(text[i:j]), j
        out.append(item)
        while text[i] == " ":
            i += 1
        if text[i] == ",":
            i += 1
        elif text[i] != "]":
            raise ValueError(f"expected ',' or ']' at {text[i:]!r}")


def _flow_map(text: str) -> Dict[Any, Any]:
    """Parse a flow mapping of scalars ``{a: 1, b: c}``."""
    body = text[1:-1].strip()
    out: Dict[Any, Any] = {}
    for item in filter(None, (t.strip() for t in body.split(","))):
        k, sep, v = item.partition(":")
        if not sep or any(ch in item for ch in "[]{}"):
            raise ValueError(f"unsupported flow mapping item {item!r} in {text!r}")
        out[_scalar(k)] = _scalar(v)
    return out


def _value(text: str) -> Any:
    text = text.strip()
    if text.startswith("["):
        val, end = _flow(text)
        if text[end:].strip():
            raise ValueError(f"trailing text after flow sequence: {text!r}")
        return val
    if text.startswith("{"):
        if not text.endswith("}"):
            raise ValueError(f"unterminated flow mapping: {text!r}")
        return _flow_map(text)
    return _scalar(text)


def _strip_comment(line: str) -> str:
    quote = None
    for k, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (k == 0 or line[k - 1] == " "):
            return line[:k]
    return line


def load_yaml(path) -> Dict[str, Any]:
    """Read a model YAML (the subset described in the module docstring)."""
    root: Dict[str, Any] = {}
    key: Optional[str] = None  # top-level key whose block is open
    for raw in Path(path).read_text().splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        body = line.strip()
        if indent == 0:
            k, sep, rest = body.partition(":")
            if not sep:
                raise ValueError(f"unsupported YAML line: {raw!r}")
            key = k.strip()
            root[key] = _value(rest) if rest.strip() else None
        elif key is None:
            raise ValueError(f"indented line outside a block: {raw!r}")
        elif body.startswith("- "):
            if root[key] is None:
                root[key] = []
            root[key].append(_value(body[2:]))
        else:
            k, sep, rest = body.partition(":")
            if not sep:
                raise ValueError(f"unsupported YAML line: {raw!r}")
            if root[key] is None:
                root[key] = {}
            root[key][_scalar(k)] = _value(rest)
    return root
