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

# The cfg/default.yaml keys the Predictor and the trainers read, with the JAX
# defaults. spd_serving (on, as in the JAX package) serves layer 0 through
# the fused stem kernel (nn/modules.py Conv.fused_stem). The trainers raise
# on the training options they have not ported (engine/trainer.py,
# engine/trainer3d.py); the distillation keys are here only to raise.
DEFAULTS: Dict[str, Any] = {
    # predict
    "conf": None,
    "max_det": 50,
    "imgsz": [960, 640],
    "classes": None,
    "int8": False,
    "spd_serving": True,
    "device_preprocess": True,  # same-shape uint8 chunks letterboxed on the device
    "source": None,
    "stream": False,
    "vid_stride": 1,
    "save_txt": False,
    "save_crop": False,
    # train
    "model": None,
    "data": None,
    "device": None,
    "epochs": 400,
    "batch": 32,
    "save": True,
    "save_dir": None,
    "save_period": -1,
    "ckpt_period_steps": 0,
    "val": True,
    "cache": False,
    "workers": 4,
    "optimizer": "AdamW",
    "seed": 5,
    "single_cls": False,
    "rect": False,
    "cos_lr": False,
    "close_mosaic": 10,
    "resume": False,
    "device_aug": False,
    "amp": True,
    "fraction": 1.0,
    "multi_scale": False,
    "lr0": 0.001,
    "lrf": 0.01,
    "momentum": 0.937,
    "weight_decay": 0.0005,
    "warmup_epochs": 3.0,
    "warmup_momentum": 0.8,
    "warmup_bias_lr": 0.1,
    "box": 5.0,
    "cls": 1.0,
    "dfl": 1.5,
    "nbs": 64,
    "hsv_h": 0.015,
    "hsv_s": 0.7,
    "hsv_v": 0.4,
    "degrees": 0.0,
    "scale": 0.4,
    "shear": 0.0,
    "perspective": 0.0,
    "flipud": 0.0,
    "fliplr": 0.5,
    "mosaic": 1.0,
    "mosaic9": 0.0,
    "copy_paste": 0.0,  # the segment task's (item 13); detection draws nothing for it
    "patience": 150,
    "val_period": 1,
    "pretrained": True,
    # 3D loss gains
    "loss2d": 2.0,
    "depth": 1.0,
    "offset3d": 10.0,
    "size3d": 1.0,
    "heading": 1.0,
    # 3D task-aligned assignment
    "tal_topk": 8,
    "tal_alpha": 0.5,
    "tal_beta": 1.0,
    "tal_gamma": 1.0,
    "tal_3d": True,
    "tal_2d": True,
    "kps_dist_metric": "l1",
    "constrain_anchors": True,
    # 3D training extras and the KITTI dataset's augmentation
    "htl": False,
    "close_mixup": 0,
    "max_depth_threshold": 120,
    "min_depth_threshold": 1,
    "min_scale": 0.8,
    "max_scale": 1.2,
    "translate": 0.1,
    "random_crop": 0.5,
    "mixup": 0.5,
    "cam_dis": False,
    "kitti_resolution": None,
    "load_depth_maps": False,
    "fgdm_loss": False,
    "fgdm_loss_weight": 2,
    "use_o2m_depth": False,
    "use_dino_depth": False,
    "distillation": False,
    "distillation_temp": 2,
    "distillation_weight": 0.75,
    "distillation_loss": "soft",
    "distillation_no_mixup": True,
    "fgdm_supervision": False,
    "fgdm_supervision_weight": 1,
    "dino_path": None,
}


def get_cfg(overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """DEFAULTS < overrides; an unknown key is an error, as in the JAX get_cfg."""
    overrides = dict(overrides or {})
    unknown = sorted(set(overrides) - set(DEFAULTS))
    if unknown:
        raise KeyError(f"unknown config keys {unknown}; valid keys: {sorted(DEFAULTS)}")
    return {**DEFAULTS, **overrides}


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
    """'yolov10s.yaml' / 'yolov10s' / a path -> the YAML file."""
    p = Path(name)
    if p.exists():
        return p
    for family in ("v10", "v10-3D"):
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
