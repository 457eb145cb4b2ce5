"""Neural-net building blocks of the YOLOv10 main path, NCHW.

Port of ``yolov10_3d_tpu/nn/modules.py``: the same class names and child
names, so the JAX parameter tree maps 1:1 onto these modules' state_dict
(see ``utils/weights.py``). Each block takes its input channel count ``c1``
explicitly, as torch modules do; the flax blocks infer it from the input.

Numerical conventions, as in the JAX package:
  - activation SiLU;
  - BatchNorm eps 1e-3, torch momentum 0.03 (flax keep-fraction 0.97);
    eval normalises with the running statistics;
  - "same" autopad p = k // 2;
  - dtypes follow the input, as the JAX modules' ``dtype=x.dtype``: a
    ``Conv`` (and a ``DeformableConv2d``) computes in its input's dtype with
    its float32 parameters cast to it, and its BatchNorm outputs that dtype
    from float32 statistics and parameters (torch's BatchNorm takes a
    bfloat16 input with float32 parameters so); a bare ``nn.Conv2d`` run by
    ``run`` promotes its input to its parameters' dtype, as flax's default
    dtype does. A bfloat16 input (amp) so runs in bfloat16 up to the heads'
    last 1x1 convs, which compute in float32.

Every forward takes ``plan``, the int8 plan of the call (``nn/quant.py``), or
None for float32. A ``Conv`` the plan routes to a fused kernel returns int8
NHWC codes; only the blocks that hold such a producer (Bottleneck, SPPF,
PSA and the head's box branches) ever see them.

``Conv.fused_stem`` is the serving route of layer 0 (``spd_serving``): the
whole Conv + BatchNorm + SiLU in one launch of the stem kernel
(``kernels/stem.py``), with the BatchNorm folded into the weights.

``Conv(..., deform=True)`` (the 3D head's ``deform`` option) convolves with
``DeformableConv2d``, a modulated deformable conv (``ops/deform.py``).
``Conv(..., spd=True)`` (``build_model(..., spd_stem=...)``) computes its 3x3
stride-2 conv through space-to-depth (``ops/spd_stem.py``), with the same
weight.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.stem import fold_bn, stem_conv
from ..ops.deform import deform_conv2d
from ..ops.spd_stem import spd_conv

BN_EPS = 1e-3
BN_MOMENTUM = 0.03  # torch momentum == 1 - flax keep-fraction (0.97)


def autopad(k: int, p: Optional[int] = None, d: int = 1) -> int:
    """'same'-shape padding."""
    if d > 1:
        k = d * (k - 1) + 1
    if p is None:
        p = k // 2
    return p


def run(m: nn.Module, x, plan):
    """``m(x)``, handing the int8 plan to the port's blocks; runs an
    ``nn.Sequential`` child by child, a bare conv through ``promoted``."""
    if isinstance(m, nn.Sequential):
        for sub in m:
            x = run(sub, x, plan)
        return x
    return promoted(m, x) if isinstance(m, nn.Conv2d) else m(x, plan)


def promoted(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``m(x)`` with ``x`` promoted to the dtype of ``m``'s parameters where
    it is narrower (flax's default dtype: a bfloat16 input to a float32
    layer computes in float32)."""
    return m(x.to(torch.promote_types(x.dtype, next(m.parameters()).dtype)))


def conv_as_input(c: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``c(x)`` computed in ``x``'s dtype (the JAX ``dtype=x.dtype``): the
    parameters are cast to it where they differ."""
    if x.dtype == c.weight.dtype:
        return c(x)
    b = c.bias.to(x.dtype) if c.bias is not None else None
    return F.conv2d(x, c.weight.to(x.dtype), b, c.stride, c.padding, c.dilation, c.groups)


class DeformableConv2d(nn.Module):
    """Modulated deformable conv v2 (the JAX ``DeformableConv2d``): the
    offsets (2 k^2 channels) and the modulator (k^2 channels, through
    2 * sigmoid) come from convs with biases and zero initial weights, so
    the layer starts as the plain conv of ``regular_conv``'s weight. Child
    names are the reference's; the JAX package's ``.pt`` export spells the
    modulator ``modulator.conv`` (``utils/weights.py``)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, p: int = 1):
        super().__init__()
        self.stride, self.padding = (s, s), (p, p)
        self.offset_conv = nn.Conv2d(c1, 2 * k * k, k, s, p, bias=True)
        self.modulator_conv = nn.Conv2d(c1, k * k, k, s, p, bias=True)
        self.regular_conv = nn.Conv2d(c1, c2, k, s, p, bias=False)
        self.reset_offsets()

    @torch.no_grad()
    def reset_offsets(self) -> None:
        """Zero the offset and modulator convs (the layer's initial state)."""
        for m in (self.offset_conv, self.modulator_conv):
            m.weight.zero_()
            m.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        offset = conv_as_input(self.offset_conv, x)
        modulator = 2.0 * torch.sigmoid(conv_as_input(self.modulator_conv, x))
        return deform_conv2d(x, offset, modulator, self.regular_conv.weight.to(x.dtype), None,
                             stride=self.stride, padding=self.padding)


class Conv(nn.Module):
    """Conv2d (no bias) + BatchNorm + SiLU; ``g`` groups (depthwise at g == c1).
    ``deform`` convolves with a ``DeformableConv2d`` instead, which ignores
    ``g`` and ``d`` as the JAX Conv does. ``spd`` computes a 3x3 stride-2
    pad-1 conv as its space-to-depth rewrite (float only: outside the int8
    gate, as in JAX).
    ``int8_cache`` holds the int8 weights of int8 serving (``nn/quant.py``),
    ``stem_cache`` the folded weights of ``fused_stem``."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 p: Optional[int] = None, g: int = 1, d: int = 1, act: bool = True,
                 deform: bool = False, spd: bool = False):
        super().__init__()
        if spd and (deform or k != 3 or s != 2 or autopad(k, p, d) != 1 or g != 1 or d != 1):
            raise ValueError("the space-to-depth rewrite takes a dense 3x3 stride-2 pad-1 conv")
        self.spd = spd
        if deform:
            self.conv = DeformableConv2d(c1, c2, k, s, autopad(k, p, d))
        else:
            self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), dilation=d,
                                  groups=g, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = nn.SiLU() if act is True else nn.Identity()
        self.int8_cache = None
        self.stem_cache = None

    def forward(self, x: torch.Tensor, plan=None) -> torch.Tensor:
        route = plan.route(self, x) if plan is not None else None
        if route is not None:
            return plan.run(self, x, route)
        if self.spd:
            y = spd_conv(x, self.conv.weight.to(x.dtype))
        elif isinstance(self.conv, nn.Conv2d):
            y = conv_as_input(self.conv, x)
        else:
            y = self.conv(x)
        return self.act(self.bn(y))

    def fused_stem(self, x: torch.Tensor) -> torch.Tensor:
        """The eval forward of a 3 -> C, 3x3 stride-2 stem with SiLU as one
        stem-kernel launch (the twin on the CPU). The folded weights are
        computed once and kept while the parameters and statistics stay the
        same tensors at the same versions (``load_state_dict``, calibration
        and ``.to`` all change a pointer or a version)."""
        c = self.conv
        if self.training:
            raise RuntimeError("the fused stem serves eval only: training normalises with "
                               "batch statistics")
        if not (c.in_channels == 3 and c.kernel_size == (3, 3) and c.stride == (2, 2)
                and c.padding == (1, 1) and c.dilation == (1, 1) and c.groups == 1
                and isinstance(self.act, nn.SiLU)):
            raise ValueError("the fused stem needs a 3-channel 3x3 stride-2 pad-1 Conv with SiLU")
        bn = self.bn
        ts = (c.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var)
        key = tuple((t.data_ptr(), t._version) for t in ts)
        if self.stem_cache is None or self.stem_cache[0] != key:
            self.stem_cache = (key, *fold_bn(c.weight, bn))
        _, w, b = self.stem_cache
        return stem_conv(x.contiguous(), w, b)


class Bottleneck(nn.Module):
    """Standard bottleneck."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1,
                 k: Sequence[int] = (3, 3), e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0], 1)
        self.cv2 = Conv(c_, c2, k[1], 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor, plan=None) -> torch.Tensor:
        y = self.cv2(self.cv1(x, plan), plan)
        return x + y if self.add else y


class C2f(nn.Module):
    """Fast CSP bottleneck with 2 convs."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False,
                 g: int = 1, e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(
            Bottleneck(self.c, self.c, shortcut, g, k=(3, 3), e=1.0) for _ in range(n)
        )

    def forward(self, x: torch.Tensor, plan=None) -> torch.Tensor:
        y = list(self.cv1(x, plan).chunk(2, 1))
        for m in self.m:
            y.append(m(y[-1], plan))
        return self.cv2(torch.cat(y, 1), plan)


class C2(nn.Module):
    """CSP bottleneck with 2 convs (the JAX ``C2``; yolov8-p6's neck)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv(2 * self.c, c2, 1)
        self.m = nn.ModuleList(
            Bottleneck(self.c, self.c, shortcut, g, k=(3, 3), e=1.0) for _ in range(n)
        )

    def forward(self, x: torch.Tensor, plan=None) -> torch.Tensor:
        a, b = self.cv1(x, plan).chunk(2, 1)
        for m in self.m:
            a = m(a, plan)
        return self.cv2(torch.cat([a, b], 1), plan)


class Proto(nn.Module):
    """Mask prototypes of the segmentation head (the JAX ``Proto``): Conv 3x3,
    a 2x2 stride-2 transposed conv with bias, Conv 3x3, Conv 1x1 -> ``c2``
    prototype planes at twice the input's resolution."""

    def __init__(self, c1: int, c_: int = 256, c2: int = 32):
        super().__init__()
        self.cv1 = Conv(c1, c_, 3)
        self.upsample = nn.ConvTranspose2d(c_, c_, 2, 2, 0, bias=True)
        self.cv2 = Conv(c_, c_, 3)
        self.cv3 = Conv(c_, c2)

    def forward(self, x: torch.Tensor, plan=None) -> torch.Tensor:
        x = promoted(self.upsample, self.cv1(x, plan))
        return self.cv3(self.cv2(x, plan), plan)


class SPPF(nn.Module):
    """Spatial pyramid pooling - fast; max-pool pads with -inf, as flax's."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * 4, c2, 1, 1)
        self.m = nn.MaxPool2d(kernel_size=k, stride=1, padding=k // 2)

    def forward(self, x: torch.Tensor, plan=None) -> torch.Tensor:
        x = self.cv1(x, plan)
        if x.dtype == torch.int8:  # codes (NHWC): the pools commute with quantization
            c = x.permute(0, 3, 1, 2).float()  # exact
            y1 = self.m(c)
            y2 = self.m(y1)
            cat = torch.cat([c, y1, y2, self.m(y2)], 1).to(torch.int8)
            return self.cv2(cat.permute(0, 2, 3, 1).contiguous(), plan)
        y1 = self.m(x)
        y2 = self.m(y1)
        return self.cv2(torch.cat([x, y1, y2, self.m(y2)], 1), plan)


class SCDown(nn.Module):
    """Spatial-channel decoupled downsample."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 2):
        super().__init__()
        self.cv1 = Conv(c1, c2, 1, 1)
        self.cv2 = Conv(c2, c2, k, s, g=c2, act=False)

    def forward(self, x: torch.Tensor, plan=None) -> torch.Tensor:
        return self.cv2(self.cv1(x, plan), plan)


class RepVGGDW(nn.Module):
    """7x7 dw conv + 3x3 dw conv, summed, SiLU (train form)."""

    def __init__(self, ed: int):
        super().__init__()
        self.conv = Conv(ed, ed, 7, 1, 3, g=ed, act=False)
        self.conv1 = Conv(ed, ed, 3, 1, 1, g=ed, act=False)

    def forward(self, x: torch.Tensor, plan=None) -> torch.Tensor:
        return F.silu(self.conv(x, plan) + self.conv1(x, plan))


class CIB(nn.Module):
    """Compact inverted block."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, e: float = 0.5,
                 lk: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = nn.Sequential(
            Conv(c1, c1, 3, g=c1),
            Conv(c1, 2 * c_, 1),
            RepVGGDW(2 * c_) if lk else Conv(2 * c_, 2 * c_, 3, g=2 * c_),
            Conv(2 * c_, c2, 1),
            Conv(c2, c2, 3, g=c2),
        )
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor, plan=None) -> torch.Tensor:
        y = run(self.cv1, x, plan)
        return x + y if self.add else y


class C2fCIB(C2f):
    """C2f with CIB inner blocks."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False,
                 lk: bool = False, g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e)
        self.m = nn.ModuleList(
            CIB(self.c, self.c, shortcut, e=1.0, lk=lk) for _ in range(n)
        )


class Attention(nn.Module):
    """Multi-head self-attention with a positional-encoding conv on v.

    The qkv channels are grouped per head as [q (key_dim), k (key_dim),
    v (head_dim)], which is the JAX package's NHWC reshape
    (B, N, heads, 2*key_dim + head_dim). Plain matmul + softmax, so the
    numerics follow the JAX einsums.
    """

    def __init__(self, dim: int, num_heads: int = 8, attn_ratio: float = 0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.scale = self.key_dim ** -0.5
        h = dim + self.key_dim * num_heads * 2
        self.qkv = Conv(dim, h, 1, act=False)
        self.proj = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 3, 1, g=dim, act=False)

    def forward(self, x: torch.Tensor, plan=None) -> torch.Tensor:
        B, C, H, W = x.shape
        N = H * W
        qkv = self.qkv(x, plan).view(B, self.num_heads, 2 * self.key_dim + self.head_dim, N)
        q, k, v = qkv.split([self.key_dim, self.key_dim, self.head_dim], dim=2)
        attn = (q.transpose(-2, -1) @ k) * self.scale  # (B, heads, N, N)
        attn = attn.softmax(dim=-1)
        out = (v @ attn.transpose(-2, -1)).reshape(B, C, H, W)
        out = out + self.pe(v.reshape(B, C, H, W), plan)
        return self.proj(out, plan)


class PSA(nn.Module):
    """Partial self-attention block (c2 == c1)."""

    def __init__(self, c1: int, c2: int, e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv(2 * self.c, c2, 1)
        self.attn = Attention(self.c, attn_ratio=0.5, num_heads=self.c // 64)
        self.ffn = nn.Sequential(
            Conv(self.c, self.c * 2, 1), Conv(self.c * 2, self.c, 1, act=False)
        )

    def forward(self, x: torch.Tensor, plan=None) -> torch.Tensor:
        a, b = self.cv1(x, plan).split((self.c, self.c), dim=1)
        b = b + self.attn(b, plan)
        b = b + run(self.ffn, b, plan)
        return self.cv2(torch.cat((a, b), 1), plan)


class Concat(nn.Module):
    """Channel concat."""

    def __init__(self, dimension: int = 1):
        super().__init__()
        self.d = dimension

    def forward(self, xs: Sequence[torch.Tensor], plan=None) -> torch.Tensor:
        return torch.cat(list(xs), self.d)


class Upsample(nn.Module):
    """Nearest-neighbour upsample by an integer factor."""

    def __init__(self, scale: int = 2):
        super().__init__()
        self.scale = scale

    def forward(self, x: torch.Tensor, plan=None) -> torch.Tensor:
        return F.interpolate(x, scale_factor=self.scale, mode="nearest")


def dfl_decode(box_logits: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """Integral (DFL) box decode: softmax over reg_max bins -> expectation.

    (..., 4*reg_max) -> (..., 4). Parameter-free: the reference's frozen
    arange conv is this projection. The sums run bin by bin, as kernel K1
    (csrc/decode_detect.cu) runs them, so the two round alike.
    """
    x = box_logits.float().reshape(*box_logits.shape[:-1], 4, reg_max)
    m = x.amax(-1)
    s = torch.zeros_like(m)
    p = torch.zeros_like(m)
    for j in range(reg_max):
        e = torch.exp(x[..., j] - m)
        s = s + e
        p = p + e * float(j)
    return p / s
