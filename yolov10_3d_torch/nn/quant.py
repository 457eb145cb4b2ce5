"""int8 serving: the port of the JAX package's int8 mode (``yolov10_3d_tpu/nn/
modules.py`` ``set_int8_mode``, ``int8_conv`` and ``_Int8Conv``).

A gated ``Conv`` quantizes its input per tensor (static scale 8/127, or
dynamic max-abs), its weights per output channel, accumulates int8 x int8
in int32 and dequantizes before its BatchNorm and activation. The gate is
JAX's (``nn/modules.py`` ``Conv``, in its order): a deformable conv and a
space-to-depth conv (``spd_stem``) are never gated; in scope ``all`` every
other ``Conv`` is, grouped and depthwise ones included; otherwise groups 1
and either a kh >= 3 filter or, in scope ``k3deep``, an input of at most
``INT8_DEEP_HW`` pixels. Other convs, and the raw ``nn.Conv2d`` layers (the
heads' last 1x1s, ``DepthPredictor``, a deformable conv's offsets), stay
float32.

The configuration is an ``Int8Config`` value that the caller passes with
each forward (``YOLOModel.forward(x, int8=cfg)``; the Predictor holds its
own), never a process-wide switch, so float and int8 callers can share one
model.

``plan_int8`` fixes, for a model and an input size, the route of every
gated conv:

- ``int8_mm_fused`` (kernel K2) and ``int8_conv3x3_fused`` (K3) for a
  producer whose output only feeds gated convs: ``SPPF.cv1`` (through the
  max-pools, which commute with the monotone quantization) and ``PSA``'s
  ``ffn[0]`` (1x1, K2); ``Bottleneck.cv1`` and the head's first box conv
  (3x3 stride 1, K3). They requantize to the consumer's static scale in
  their epilogue and hand it int8 NHWC codes, which equal the consumer's own
  quantization of the float output up to float rounding in that epilogue.
- ``int8_conv_f32`` for every other gated conv with groups 1, a 1x1 or 3x3
  filter, stride 1 or 2 and no dilation: float32 NCHW out, so the float
  parts of the net (residual adds, attention, the float convs) see what
  they see in the JAX int8 path.
- ``int8_group_conv_f32`` for the rest (scope ``all``'s grouped and
  depthwise convs, and any other filter), float32 NCHW out as well. A
  depthwise conv on it (every grouped conv of the shipped models) takes its
  float NCHW input as it arrives and quantizes inside the kernel
  (``int8_dw_conv_f32``: one launch, or two under the dynamic scale); a
  grouped conv with C / g > 1, or one fed codes by a fused producer, which no
  shipped plan has, is quantized first and takes the codes-in kernel.

``V10Detect3d`` is planned like ``V10Detect``: each branch's convs at its
level's size; the first conv of a standard branch [Conv(k1), Conv(k2), 1x1]
other than ``dep`` (whose first output is also the dep embedding) is a
fused producer for its second, as the box branches' are. Under int8 the
head runs its dense route (JAX ``heads3d.py`` ``_fusable``).

Quantization follows JAX's ``int8_conv`` as XLA compiles it under ``jit``:
a division by a constant becomes a product with the constant's float32
reciprocal, so a static scale quantizes as ``x * fl(1/sx)`` and both
``/ 127.0`` become ``* fl(1/127)``; the dynamic activation scale and the
weight scale are data, and the divisions by them stay divisions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import int8 as K8
from ..kernels.int8 import RECIP_127, quantize_act, recip32
from . import heads as Hd
from . import heads3d as H3
from . import modules as M

INT8_DEEP_HW = 512  # k3deep: a 1x1 conv quantizes when its input has H*W <= this
STATIC_ACT_SCALE = 8.0 / 127.0  # the JAX Predictor's scale: |x| <= 8 after SiLU on BN'd nets
ROUTES = ("int8_mm_fused", "int8_conv3x3_fused", "int8_conv_f32",
          "int8_group_conv_f32")  # kernel names; the grouped route also runs int8_dw_conv_f32
SCOPES = ("k3", "k3deep", "all")


@dataclasses.dataclass(frozen=True)
class Int8Config:
    """int8 serving options. ``act_scale``: the static activation scale, or
    None for the dynamic max-abs scale (float epilogues only). ``scope``:
    ``k3``, ``k3deep`` or ``all`` (every ``Conv``, grouped and depthwise
    ones included)."""

    act_scale: Optional[float] = STATIC_ACT_SCALE
    scope: str = "k3deep"

    def __post_init__(self):
        if self.scope not in SCOPES:
            raise ValueError(f"int8 scope must be one of {SCOPES}, got {self.scope!r}")
        if self.act_scale is not None and not self.act_scale > 0:
            raise ValueError(f"act_scale must be > 0 or None, got {self.act_scale}")


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``int8_conv``'s weight quantization of an OIHW float weight: (int8
    OIHW codes, float32 per-output-channel scale)."""
    sw = w.abs().amax(dim=(1, 2, 3)) * RECIP_127 + 1e-12
    wq = torch.round(w / sw[:, None, None, None]).clamp_(-127, 127).to(torch.int8)
    return wq, sw


def pad_channels(x: torch.Tensor, k: int) -> torch.Tensor:
    """Contiguous channels-last codes, channels zero-padded to ``k``."""
    return (F.pad(x, (0, k - x.shape[-1])) if x.shape[-1] != k else x).contiguous()


def _pad4(c: int) -> int:
    return -(-c // 4) * 4


def gated(conv: M.Conv, hw: int, cfg: Int8Config) -> bool:
    """The JAX gate (``nn/modules.py`` Conv), in its order: never a
    deformable or a space-to-depth conv; in scope all, every other conv;
    else g == 1 and kh >= 3, or in k3deep a 1x1 whose input has ``hw`` <=
    INT8_DEEP_HW pixels."""
    c = conv.conv
    if not isinstance(c, nn.Conv2d) or conv.spd:
        return False
    if cfg.scope == "all":
        return True
    if c.groups != 1:
        return False
    return c.kernel_size[0] >= 3 or (cfg.scope == "k3deep" and hw <= INT8_DEEP_HW)


def _grouped(c: nn.Conv2d) -> bool:
    """Whether ``int8_conv_f32`` cannot take the conv (its kernel is dense,
    1x1 or 3x3, stride 1 or 2, undilated): the route is then
    ``int8_group_conv_f32``, which takes any of them."""
    k = c.kernel_size
    return (c.groups != 1 or k[0] != k[1] or k[0] not in (1, 3) or c.stride[0] != c.stride[1]
            or c.stride[0] not in (1, 2) or c.padding[0] != c.padding[1]
            or c.dilation != (1, 1))


@dataclasses.dataclass
class _Weights:
    key: tuple
    w: torch.Tensor  # int8 (N, kh, kw, Kp); (N, kh, kw, C / g) unpadded on the grouped route
    sw: torch.Tensor  # float32 (N,)
    ep: torch.Tensor  # float32 (4, N): deq (for a static scale), mean, mul, beta


def _weights(conv: M.Conv, act_scale: Optional[float]) -> _Weights:
    """The conv's int8 weights and epilogue, computed once and kept on the
    module while its parameters and statistics stay the same tensors at the
    same versions (``load_state_dict``, calibration and ``.to`` all change a
    pointer or a version)."""
    bn = conv.bn
    ts = (conv.conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var)
    key = tuple((t.data_ptr(), t._version) for t in ts) + (act_scale,)
    cached = conv.int8_cache
    if cached is not None and cached.key == key:
        return cached
    with torch.no_grad():
        wq, sw = quantize_weight(conv.conv.weight.float())
        k = wq.shape[1] if _grouped(conv.conv) else _pad4(wq.shape[1])
        wq = pad_channels(wq.permute(0, 2, 3, 1), k)
        mul = torch.rsqrt(bn.running_var.float() + bn.eps) * bn.weight.float()
        deq = sw * float(np.float32(act_scale)) if act_scale is not None else torch.zeros_like(sw)
        ep = torch.stack([deq, bn.running_mean.float(), mul, bn.bias.float()]).contiguous()
    conv.int8_cache = _Weights(key, wq, sw, ep)
    return conv.int8_cache


class Int8Plan:
    """The route of every gated conv of one model at one input size."""

    def __init__(self, cfg: Int8Config, hw: Dict[M.Conv, int], routes: Dict[M.Conv, str],
                 names: Dict[M.Conv, str], codes_in: FrozenSet[M.Conv] = frozenset()):
        self.cfg = cfg
        self.hw = hw  # input H*W of every conv the forward runs
        self.routes = routes  # gated conv -> route, in forward order
        self.names = names  # conv -> module path
        self.codes_in = codes_in  # the gated convs a fused producer hands int8 codes

    def counts(self) -> Dict[str, int]:
        """Kernel launches one forward makes, per route (every route, 0 where
        the plan has none)."""
        return {r: sum(v == r for v in self.routes.values()) for r in ROUTES}

    def launches(self) -> Dict[str, int]:
        """Kernel launches one forward makes, per kernel (``launch_counts``'
        int8 keys): the grouped route splits into ``int8_dw_conv_f32`` (and
        ``int8_act_absmax`` under the dynamic scale) for a depthwise conv fed
        float input, ``int8_group_conv_f32`` otherwise."""
        out = dict.fromkeys((*ROUTES, "int8_dw_conv_f32", "int8_act_absmax"), 0)
        for conv, r in self.routes.items():
            if r == "int8_group_conv_f32" and _dw_float_in(conv, conv in self.codes_in):
                out["int8_dw_conv_f32"] += 1
                out["int8_act_absmax"] += self.cfg.act_scale is None
            else:
                out[r] += 1
        return out

    def paths(self) -> Dict[str, str]:
        """Module path -> route of the gated convs."""
        return {self.names[c]: r for c, r in self.routes.items()}

    def route(self, conv: M.Conv, x: torch.Tensor) -> Optional[str]:
        """The conv's route, or None for float32; checks the planned input
        size against the tensor's (int8 tensors are NHWC)."""
        hw = x.shape[1] * x.shape[2] if x.dtype == torch.int8 else x.shape[-2] * x.shape[-1]
        if self.hw.get(conv) != hw:
            raise RuntimeError(f"int8 plan made for {self.hw.get(conv)} input pixels at "
                               f"{self.names.get(conv, '?')}, got {hw}")
        return self.routes.get(conv)

    def run(self, conv: M.Conv, x: torch.Tensor, route: str) -> torch.Tensor:
        """The gated conv: float NCHW or int8 NHWC codes in; int8 NHWC codes
        out on a fused route, float32 NCHW out otherwise."""
        c = conv.conv
        scale = self.cfg.act_scale
        w = _weights(conv, scale)
        act = isinstance(conv.act, nn.SiLU)
        if route == "int8_group_conv_f32" and _dw_float_in(conv, x.dtype == torch.int8):
            x = x if x[0].is_contiguous() else x.contiguous()  # a no-op on the shipped models
            return K8.int8_dw_conv_f32(x, w.w, w.ep, w.sw, scale, c.stride[0], c.padding[0],
                                       c.dilation[0], act)
        kp = c.in_channels if route == "int8_group_conv_f32" else w.w.shape[-1]
        if x.dtype == torch.int8:  # a fused producer's codes, at the static scale
            ep = w.ep
            xq = pad_channels(x, kp)
        else:
            q, sx = quantize_act(x, scale)
            xq = pad_channels(q.permute(0, 2, 3, 1), kp)
            ep = w.ep if scale is not None else torch.cat([(w.sw * sx)[None], w.ep[1:]])
        if route == "int8_group_conv_f32":
            return K8.int8_group_conv_f32(xq, w.w, ep, c.stride[0], c.padding[0],
                                          c.dilation[0], c.groups, act)
        if route == "int8_mm_fused":
            B, H, W_, _ = xq.shape
            out = K8.int8_mm_fused(xq.view(-1, kp), w.w.view(-1, kp), ep, recip32(scale))
            return out.view(B, H, W_, -1)
        if route == "int8_conv3x3_fused":
            return K8.int8_conv3x3_fused(xq, w.w, ep, recip32(scale))
        return K8.int8_conv_f32(xq, w.w, ep, c.stride[0], c.padding[0], act)


def _dw_float_in(conv: M.Conv, codes: bool) -> bool:
    """Whether a conv on the grouped route runs ``int8_dw_conv_f32``: a
    depthwise conv given float input (not a fused producer's codes)."""
    c = conv.conv
    return not codes and c.groups == c.in_channels == c.out_channels


def _fusable(p: M.Conv, c: M.Conv, routes: Dict[M.Conv, str], cfg: Int8Config):
    """The fused route of producer ``p`` feeding only gated ``c``, or None."""
    if cfg.act_scale is None or p not in routes or c not in routes:
        return None
    if not isinstance(p.act, nn.SiLU) or p.conv.groups != 1:  # K2 and K3 are dense
        return None
    k, s, pad, d = p.conv.kernel_size, p.conv.stride, p.conv.padding, p.conv.dilation
    if s != (1, 1) or d != (1, 1):
        return None
    if k == (1, 1) and pad == (0, 0):
        return "int8_mm_fused"
    if k == (3, 3) and pad == (1, 1):
        return "int8_conv3x3_fused"
    return None


def _producer_pairs(model: nn.Module):
    """(producer, consumer) convs whose producer output reaches nothing but
    the consumer; the blocks' forwards pass int8 codes between them."""
    for m in model.modules():
        if isinstance(m, (M.Bottleneck, M.SPPF)):
            yield m.cv1, m.cv2
        elif isinstance(m, M.PSA):
            yield m.ffn[0], m.ffn[1]
        elif isinstance(m, Hd.V10Detect):  # the box branches
            for seq in (*m.cv2, *m.one2one_cv2):
                yield seq[0], seq[1]
        elif isinstance(m, H3.V10Detect3d):  # the standard branches but dep's
            for heads in (m.o2o_heads(), list(m.o2m_heads)):
                for name, levels in zip(H3.BRANCHES, heads):
                    for seq in levels if name != "dep" else ():
                        if isinstance(seq[0], M.Conv) and isinstance(seq[1], M.Conv):
                            yield seq[0], seq[1]


def _head_branches(head: nn.Module, lv: int, one2many: bool):
    """The modules of a v10Detect or v10Detect3d head that run at level ``lv``."""
    if isinstance(head, H3.V10Detect3d):
        mods = [h[lv] for h in head.o2o_heads()]
        if one2many:
            mods += [h[lv] for h in head.o2m_heads]
        if head.common_head:
            mods.append(head.common[lv])
        return mods
    mods = [head.one2one_cv2[lv], head.one2one_cv3[lv]]
    if one2many:
        mods += [head.cv2[lv], head.cv3[lv]]
    return mods


def plan_int8(model: nn.Module, hw: Tuple[int, int], cfg: Int8Config,
              one2many: bool = False, stem: bool = False) -> Int8Plan:
    """The int8 plan of a ``YOLOModel`` for an (H, W) input, cached on the
    model. Every conv of a YOLOv10 layer sees the layer's input size (the
    strided convs come first in their blocks); the head's convs see their
    level's (a v10Detect or v10Detect3d head). ``stem=True`` (the fused stem
    route of ``spd_serving``) leaves layer 0 out of the int8 convs, as the
    JAX package's space-to-depth stem takes it out of its int8 gate."""
    if model.spec.head_module not in ("v10Detect", "v10Detect3d"):
        raise NotImplementedError(f"int8 serving of {model.spec.head_module}: ROADMAP item 25")
    H, W = hw
    stride = max(model.spec.strides) if model.spec.strides else 32
    if H % stride or W % stride:
        raise ValueError(f"int8 input {H}x{W} must be a multiple of the stride {stride}")
    key = (H, W, cfg, one2many, stem)
    plan = model.int8_plans.get(key)
    if plan is not None:
        return plan
    spec = model.spec
    sizes: Dict[M.Conv, int] = {}
    for s, layer in zip(spec.layers, model.model):
        if s.i == spec.head_index:
            for lv, st in enumerate(spec.strides[: layer.nl]):
                for br in _head_branches(layer, lv, one2many):
                    sizes.update((c, (H // st) * (W // st)) for c in br.modules()
                                 if isinstance(c, M.Conv))
            continue
        f0 = s.f if isinstance(s.f, int) else s.f[0]
        st = 1 if s.i == 0 else spec.layers[f0 if f0 >= 0 else s.i + f0].stride
        sizes.update((c, (H // st) * (W // st)) for c in layer.modules() if isinstance(c, M.Conv))
    routes = {c: "int8_group_conv_f32" if _grouped(c.conv) else "int8_conv_f32"
              for c, n in sizes.items() if gated(c, n, cfg) and not (stem and c is model.model[0])}
    codes_in = set()
    for p, c in _producer_pairs(model):
        fused = _fusable(p, c, routes, cfg)
        if fused:
            routes[p] = fused
            codes_in.add(c)
    names = {m: n for n, m in model.named_modules() if m in sizes}
    plan = model.int8_plans[key] = Int8Plan(cfg, sizes, routes, names, frozenset(codes_in))
    return plan
