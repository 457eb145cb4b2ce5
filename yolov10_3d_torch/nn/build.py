"""YAML -> model compiler (port of ``yolov10_3d_tpu/nn/build.py``, cut to
the modules the v10, v10-3D and v8 YAMLs use: YOLOv8's detect, P6, segment,
pose and OBB models).

``parse_model_yaml`` produces the same static ``ModelSpec`` as the JAX
package; ``YOLOModel`` instantiates the layers as ``model.{i}`` (so the JAX
``model_{i}`` parameter names carry over) and walks them with a dict of
saved features.

``spd_stem`` is the JAX option of the same name: True computes layer 0, and
``"all"`` every dense 3x3 stride-2 pad-1 ``Conv`` layer of the YAML, through
the exact space-to-depth rewrite (``ops/spd_stem.py``), with unchanged
parameters.
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import math
import re
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..cfg import load_yaml
from ..device import resolve_device
from . import heads as H
from . import heads3d as H3
from . import modules as M
from .quant import Int8Config, plan_int8

HEAD_MODULES = {"v10Detect", "v10Detect3d", "Detect", "Segment", "Pose", "OBB"}
V8_HEADS = ("Detect", "Segment", "Pose", "OBB")  # the heads served through NMS
# top-level YAML keys of the 3D head's options (the JAX parser's extras)
HEAD3D_KEYS = ("dsconv", "channels", "use_predecessors", "detach_predecessors", "deform",
               "common_head", "num_scales", "half_channels", "fgdm_predictor",
               "kernel_size_1", "kernel_size_2")
# Modules following the (c1, c2, ...) channel convention
CH_MODULES = {"Conv", "Bottleneck", "SPPF", "C2f", "C2", "PSA", "SCDown", "C2fCIB"}
# Modules whose repeat count n is absorbed as an inner arg
REPEAT_MODULES = {"C2f", "C2", "C2fCIB"}


def make_divisible(x: float, divisor: int = 8) -> int:
    """Round channels up to the nearest multiple."""
    return math.ceil(x / divisor) * divisor


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    i: int                      # layer index
    f: Union[int, Tuple[int, ...]]  # input layer index/indices (-1 = previous)
    n: int                      # outer repeat count (after depth scaling)
    module: str                 # registry name
    args: Tuple[Any, ...]       # positional args (post channel-scaling)
    c2: int                     # output channels
    stride: int                 # cumulative spatial stride vs input image


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    nc: int
    layers: Tuple[LayerSpec, ...]
    save: Tuple[int, ...]       # indices whose outputs must be kept
    head_index: int
    head_module: str
    strides: Tuple[int, ...]    # detection strides, e.g. (8, 16, 32)
    yaml_extras: Tuple[Tuple[str, Any], ...] = ()  # 3D head config keys


def _freeze(x):
    if isinstance(x, list):
        return tuple(_freeze(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in x.items()))
    return x


def parse_model_yaml(
    cfg: Union[str, Path, dict], scale: Optional[str] = None, ch: int = 3,
    nc: Optional[int] = None,
) -> ModelSpec:
    """Compile a v10 model YAML into a static ModelSpec.

    Depth gain n = max(round(n*depth), 1) for n > 1; width gain
    c2 = make_divisible(min(c2, max_channels) * width, 8).
    """
    if isinstance(cfg, (str, Path)):
        stem = Path(cfg).stem
        m = re.search(r"yolov?\d*[-_]?([nsmblxce])(?:[-_.]|$)", stem) or re.search(
            r"[-_]([nsmblx])$", stem
        )
        if scale is None and m:
            scale = m.group(1)
        d = load_yaml(cfg)
    else:
        d = dict(cfg)

    d_nc = int(nc if nc is not None else d.get("nc", 80))
    depth, width, max_channels = 1.0, 1.0, float("inf")
    scales = d.get("scales")
    if scales:
        if scale is None:
            scale = next(iter(scales))
        depth, width, max_channels = scales[scale]
    extras = {k: d.get(k) for k in HEAD3D_KEYS if k in d}

    ch_list = [ch]
    layers = []
    save = []
    stride_list = []
    head_index = -1
    head_module = ""
    head_strides: Tuple[int, ...] = ()

    rows = list(d["backbone"]) + list(d["head"])
    for i, (f, n, mname, args) in enumerate(rows):
        mname = mname.replace("nn.Upsample", "Upsample")
        args = list(args)
        for j, a in enumerate(args):
            if isinstance(a, str) and a == "nc":
                args[j] = d_nc
            elif isinstance(a, str) and a == "kpt_shape":
                args[j] = list(d.get("kpt_shape", [17, 3]))
            elif isinstance(a, str):
                # 'None'/'True'/'False' arrive as strings
                with contextlib.suppress(ValueError, SyntaxError):
                    args[j] = ast.literal_eval(a)
        n = max(round(n * depth), 1) if n > 1 else n

        f_first = f if isinstance(f, int) else f[0]
        in_stride = 1 if i == 0 else stride_list[f_first]

        if mname in CH_MODULES:
            c2 = args[0]
            if c2 != d_nc:
                c2 = make_divisible(min(c2, max_channels) * width, 8)
            args = [c2, *args[1:]]
            if mname in REPEAT_MODULES:
                args.insert(1, n)
                n = 1
            s = 1
            if mname == "Conv" and len(args) >= 3:
                s = args[2]
            elif mname == "SCDown":
                s = args[2]
            out_stride = in_stride * s
        elif mname == "Upsample":
            c2 = ch_list[f]
            out_stride = in_stride // args[1]
        elif mname == "Concat":
            c2 = sum(ch_list[x] for x in f)
            out_stride = in_stride
            args = []
        elif mname in HEAD_MODULES:
            in_ch = tuple(ch_list[x] for x in f)
            head_strides = tuple(stride_list[x] for x in f)
            if mname == "Segment":  # [nc, nm, npr], npr width-scaled
                npr = args[2] if len(args) > 2 else 256
                args = [d_nc, in_ch, args[1] if len(args) > 1 else 32,
                        make_divisible(min(npr, max_channels) * width, 8)]
            elif mname == "Pose":
                args = [d_nc, in_ch, tuple(args[1]) if len(args) > 1 else (17, 3)]
            elif mname == "OBB":
                args = [d_nc, in_ch, args[1] if len(args) > 1 else 1]
            else:
                args = [d_nc, in_ch]
            c2 = 0
            out_stride = in_stride
            head_index = i
            head_module = mname
        else:
            raise ValueError(f"unknown module {mname!r} in model yaml")

        layers.append(
            LayerSpec(
                i=i,
                f=f if isinstance(f, int) else tuple(f),
                n=n,
                module=mname,
                args=tuple(_freeze(a) for a in args),
                c2=c2,
                stride=out_stride,
            )
        )
        save.extend(x % i for x in ([f] if isinstance(f, int) else f) if x != -1)
        if i == 0:
            ch_list = []
        ch_list.append(c2)
        stride_list = stride_list if i > 0 else []
        stride_list.append(out_stride)

    return ModelSpec(
        nc=d_nc,
        layers=tuple(layers),
        save=tuple(sorted(set(save))),
        head_index=head_index,
        head_module=head_module,
        strides=head_strides,
        yaml_extras=tuple(sorted((k, _freeze(v)) for k, v in extras.items())),
    )


def _build_module(spec: LayerSpec, c1: int, extras: Dict[str, Any],
                  spd_stem: Union[bool, str] = False) -> nn.Module:
    a = spec.args
    if spec.module == "Conv":
        k = a[1] if len(a) > 1 else 1
        s = a[2] if len(a) > 2 else 1
        p = a[3] if len(a) > 3 else None
        g = a[4] if len(a) > 4 else 1
        d = a[5] if len(a) > 5 else 1
        act = a[6] if len(a) > 6 else True
        # the JAX rule (build.py _build_module): layer 0, or under "all" every
        # layer, when it is a dense k3/s2/p1 conv
        spd = bool(spd_stem and (spec.i == 0 or spd_stem == "all") and k == 3 and s == 2
                   and p in (None, 1) and g == 1 and d == 1)
        return M.Conv(c1, a[0], k, s, p, g, d, act, spd=spd)
    if spec.module == "Bottleneck":
        return M.Bottleneck(c1, a[0], a[1] if len(a) > 1 else True)
    if spec.module == "C2f":
        return M.C2f(c1, a[0], a[1], a[2] if len(a) > 2 else False)
    if spec.module == "C2":
        return M.C2(c1, a[0], a[1], a[2] if len(a) > 2 else True)
    if spec.module == "C2fCIB":
        shortcut = a[2] if len(a) > 2 else False
        lk = a[3] if len(a) > 3 else False
        return M.C2fCIB(c1, a[0], a[1], shortcut, lk)
    if spec.module == "SCDown":
        return M.SCDown(c1, a[0], a[1], a[2])
    if spec.module == "SPPF":
        return M.SPPF(c1, a[0], a[1] if len(a) > 1 else 5)
    if spec.module == "PSA":
        return M.PSA(c1, a[0])
    if spec.module == "Upsample":
        return M.Upsample(int(a[1]) if len(a) > 1 and a[1] else 2)
    if spec.module == "Concat":
        return M.Concat(1)
    if spec.module == "v10Detect":
        return H.V10Detect(nc=a[0], ch=a[1])
    if spec.module == "Detect":
        return H.Detect(nc=a[0], ch=a[1])
    if spec.module == "Segment":
        return H.Segment(nc=a[0], ch=a[1], nm=a[2], npr=a[3])
    if spec.module == "Pose":
        return H.Pose(nc=a[0], ch=a[1], kpt_shape=a[2])
    if spec.module == "OBB":
        return H.OBB(nc=a[0], ch=a[1], ne=a[2])
    if spec.module == "v10Detect3d":
        return H3.V10Detect3d(nc=a[0], ch=a[1], cfg=extras)
    raise ValueError(spec.module)


class YOLOModel(nn.Module):
    """The compiled detection model: backbone + PAN neck + head, NCHW input.

    ``fast_eval`` (serving) skips the train-only one2many branches at eval;
    ``forward(x, fast_eval=...)`` overrides it per call. ``forward(x,
    int8=Int8Config(...))`` runs the call in int8 (``nn/quant.py``); the
    plans of the input sizes served so far are kept in ``int8_plans``.
    ``stem=True`` runs layer 0 as the fused stem kernel (``Conv.fused_stem``,
    the Predictor's ``spd_serving``), outside the int8 plan; ``sparse=True``
    runs a 3D head's one-to-one regression on its top-K patches (dense under
    int8). Both are serving routes: eval only, chosen per call. ``spd_stem``
    (False, True or "all") builds the space-to-depth convs; the fused stem
    of ``stem=True`` still serves layer 0.
    """

    def __init__(self, spec: ModelSpec, fast_eval: bool = False, ch: int = 3,
                 spd_stem: Union[bool, str] = False):
        super().__init__()
        if spd_stem not in (False, True, "all"):
            raise ValueError(f"spd_stem must be False, True or 'all', got {spd_stem!r}")
        self.spec = spec
        self.fast_eval = fast_eval
        self.spd_stem = spd_stem
        chans = []
        mods = []
        extras = dict(spec.yaml_extras)
        for s in spec.layers:
            if s.i == 0:
                c1 = ch
            elif isinstance(s.f, int):
                c1 = chans[s.f]
            else:
                c1 = chans[s.f[0]]
            mod = (
                _build_module(s, c1, extras, spd_stem)
                if s.n == 1
                else nn.Sequential(*(_build_module(s, c1 if j == 0 else s.c2, extras, spd_stem)
                                     for j in range(s.n)))
            )
            mods.append(mod)
            chans.append(s.c2)
        self.model = nn.ModuleList(mods)
        self.int8_plans: Dict[tuple, Any] = {}

    def forward(self, x: torch.Tensor, fast_eval: Optional[bool] = None,
                int8: Optional[Int8Config] = None, stem: bool = False, sparse: bool = False):
        """x: (B, 3, H, W) normalised image. Returns the head output."""
        fast = self.fast_eval if fast_eval is None else fast_eval
        one2many = self.training or not fast
        plan = (plan_int8(self, tuple(x.shape[-2:]), int8, one2many, stem)
                if int8 is not None else None)
        if sparse and self.spec.head_module != "v10Detect3d":
            raise ValueError(f"sparse serving is a v10Detect3d route, not {self.spec.head_module}")
        saved: Dict[int, torch.Tensor] = {}
        out = x
        for spec, layer in zip(self.spec.layers, self.model):
            def _lookup(j):
                if j == -1:
                    return out
                return saved[j if j >= 0 else spec.i + j]

            inp = [_lookup(j) for j in spec.f] if isinstance(spec.f, tuple) else _lookup(spec.f)
            if spec.module == "v10Detect3d":
                out = layer(inp, one2many=one2many, sparse=sparse, plan=plan)
            elif spec.module in HEAD_MODULES:
                out = layer(inp, one2many=one2many, plan=plan)
            elif stem and spec.i == 0:
                out = layer.fused_stem(inp)
            else:
                out = M.run(layer, inp, plan)
            if spec.i in self.spec.save:
                saved[spec.i] = out
        return out


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights: conv kernels ~ N(0, 1/fan_in) (the variance of
    flax's lecun_normal), conv biases 0, BN identity statistics; a deformable
    conv's offset and modulator convs zero, as flax initialises them."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(
                    torch.randn(m.weight.shape, generator=generator) / math.sqrt(fan_in)
                )
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        for m in model.modules():
            if isinstance(m, M.DeformableConv2d):
                m.reset_offsets()
    return model


def build_model(
    cfg: Union[str, Path, dict],
    scale: Optional[str] = None,
    nc: Optional[int] = None,
    fast_eval: bool = False,
    device: Union[str, torch.device] = "cuda",
    seed: int = 0,
    spd_stem: Union[bool, str] = False,
) -> Tuple[YOLOModel, ModelSpec]:
    """YAML -> (YOLOModel with seeded random weights on ``device``, spec)."""
    dev = resolve_device(device)
    spec = parse_model_yaml(cfg, scale=scale, nc=nc)
    model = YOLOModel(spec, fast_eval=fast_eval, spd_stem=spd_stem)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval(), spec
