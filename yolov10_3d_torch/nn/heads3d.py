"""Monocular-3D detection head (port of ``yolov10_3d_tpu/nn/heads3d.py``
``V10Detect3d``), NCHW.

Eight decoupled regression branches per scale (cls, o2d, s2d, o3d, s3d, hd,
dep, dep_un), each [Conv(k1), Conv(k2), 1x1 conv], held twice: the one-to-one
set under the branch names and the one-to-many set as ``o2m_heads.{j}``.
Child names follow the JAX tree, so its weights load with ``strict=True``.
The head returns raw per-scale maps (B, nc + 35, H, W); the decode lives in
``ops/postprocess.py`` ``decode_detect3d``.

``sparse=True`` (serving) runs the one-to-one regression branches only at
each scale's top-``SPARSE_K`` anchors by max class logit, the JAX package's
``_sparse_forward_feat``: one patch per candidate covering the receptive
field of conv2's centre, conv1 of the seven branches as one VALID conv on
the patches (BatchNorm folded to an affine), conv2 at the centre as one
batched contraction, the 1x1 convs, and a scatter into zero maps. The
detections equal the dense forward's: the candidates' values differ only by
float reassociation, and the decode's top-k can only pick candidate anchors.
A scale runs sparse only when 2 * K * k2^2 < H * W.

The YAML options of the JAX head (``nn/heads3d.py:69-155``):
``dsconv`` makes each branch's two convs depthwise-separable (a depthwise
conv, then a 1x1); ``use_predecessors`` feeds each branch the detached
outputs of the branches before it (``PREDECESSORS``, ``dep`` divided by
``DEP_NORM``); ``common_head`` runs one shared 3x3 conv per scale before
shorter branches [Conv(k1), 1x1]; ``half_channels`` halves the second conv's
width; ``deform`` makes each branch's first conv a modulated deformable conv
(``nn/modules.py`` ``DeformableConv2d``). The sparse path serves the
standard branches only: with ``dsconv``, ``use_predecessors``,
``common_head`` or ``deform`` a sparse request runs the dense head
(``sparse_ok``), whose maps it then equals exactly; ``half_channels`` stays
sparse. Under int8 (``plan``, ``nn/quant.py``) the head runs its dense route
too, as the JAX head's ``_fusable`` refuses the int8 mode: its patches would
compute the unquantized function.

The full output (training, or ``one2many``) also carries the ``dep``
branches' first-conv outputs per scale, ``o2m_embs`` and ``o2o_embs``, the
student side of the distillation losses (``train/distill.py``); a
``common_head`` head has none (None per scale), nor has the sparse path.

With ``fgdm_predictor: true`` the head also holds a ``DepthPredictor`` (the
foreground depth map of the FGDM loss), whose output the training forward
returns as ``depth_maps``. ``detect3d_bias_init`` is the 3D trainer's head
initialisation.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.topk import topk_lowest_index
from .modules import Conv, promoted, run

OUTPUT_CHANNELS = {"cls": None, "o2d": 2, "s2d": 2, "o3d": 2, "s3d": 3, "hd": 24, "dep": 1,
                   "dep_un": 1}  # cls: nc
BRANCHES = tuple(OUTPUT_CHANNELS)
SPARSE_K = 50  # per-scale candidates of the sparse path (the reference's top-50)

# the branches whose outputs each branch also reads under use_predecessors
PREDECESSORS = {"cls": [], "o2d": [], "s2d": [], "o3d": ["cls"], "s3d": ["cls"], "hd": ["cls"],
                "dep": ["cls", "s3d"], "dep_un": ["cls", "s3d", "dep"]}
DEP_NORM = 65.0  # the dep output's scale where a later branch reads it


def candidates(cls_map: torch.Tensor, k: int) -> torch.Tensor:
    """The sparse path's anchors of one scale: the flat H x W indices (B, k)
    of the top-``k`` max class logits of ``cls_map`` (B, nc, H, W), ties to
    the lowest index as ``jax.lax.top_k`` (the decode's top-k follows the
    same rule, so it picks only candidates)."""
    return topk_lowest_index(cls_map.amax(1).flatten(1), k)[1]


def _branch(c_in: int, mid: int, mid2: int, out: int, k1: int, k2: int, dsconv: bool,
            common: bool, deform: bool) -> nn.Sequential:
    """One branch at one scale: [Conv(k1), Conv(k2), 1x1 conv] (the deform
    option on the first conv); depthwise-separable pairs under ``dsconv``;
    [Conv(k1), 1x1 conv] after a common conv."""
    if common:
        return nn.Sequential(Conv(c_in, mid, k1), nn.Conv2d(mid, out, 1))
    if dsconv:
        return nn.Sequential(
            nn.Sequential(Conv(c_in, c_in, k1, g=c_in, deform=deform), Conv(c_in, mid, 1)),
            nn.Sequential(Conv(mid, mid, k2, g=mid), Conv(mid, mid2, 1)),
            nn.Conv2d(mid2, out, 1))
    return nn.Sequential(Conv(c_in, mid, k1, deform=deform), Conv(mid, mid2, k2),
                         nn.Conv2d(mid2, out, 1))


class V10Detect3d(nn.Module):
    """Raw per-scale maps out. ``cfg`` holds the YAML's head options
    (``channels``, ``num_scales``, ``kernel_size_1/2`` and the flags)."""

    def __init__(self, nc: int, ch: Sequence[int], cfg: Dict = None):
        super().__init__()
        cfg = dict(cfg or {})
        self.nc = nc
        dsconv, deform = bool(cfg.get("dsconv")), bool(cfg.get("deform"))
        self.use_predecessors = bool(cfg.get("use_predecessors"))
        self.common_head = bool(cfg.get("common_head"))
        # the sparse path's envelope: the standard branches (JAX :388-395, and
        # dsconv's per-scale dense fallback at every scale, :202-228)
        self.sparse_ok = not (dsconv or deform or self.use_predecessors or self.common_head)
        self.k1 = int(cfg.get("kernel_size_1") or 3)
        self.k2 = int(cfg.get("kernel_size_2") or 3)
        self.nl = int(cfg.get("num_scales") or len(ch))
        channels = dict(cfg.get("channels") or {})
        ch = list(ch[: self.nl])
        out_ch = {**OUTPUT_CHANNELS, "cls": nc}

        def branch(name):
            mid = int(channels.get(f"{name}_c", 128))
            mid2 = mid // 2 if cfg.get("half_channels") else mid
            # every branch's input width, the predecessors' outputs included
            extra = sum(out_ch[p] for p in PREDECESSORS[name]) if self.use_predecessors else 0
            return nn.ModuleList(
                _branch(c + extra, mid, mid2, out_ch[name], self.k1, self.k2, dsconv,
                        self.common_head, deform) for c in ch)

        for name in BRANCHES:
            self.add_module(name, branch(name))
        self.o2m_heads = nn.ModuleList(branch(name) for name in BRANCHES)
        if self.common_head:
            self.common = nn.ModuleList(
                nn.Sequential(Conv(c, c, 3, g=c), Conv(c, c, 1)) if dsconv else Conv(c, c, 3)
                for c in ch)
        if cfg.get("fgdm_predictor"):
            self.fgdm_predictor = DepthPredictor(ch)

    def o2o_heads(self) -> List[nn.ModuleList]:
        return [getattr(self, name) for name in BRANCHES]

    def _forward_feat(self, xs, heads, plan
                      ) -> Tuple[List[torch.Tensor], List[Optional[torch.Tensor]]]:
        """All eight branches densely at every scale -> (maps, the dep
        branch's first-conv outputs, None under common_head)."""
        ys, embs = [], []
        for i, x in enumerate(xs):
            if self.common_head:
                x = run(self.common[i], x, plan)
            outputs, emb = {}, None
            for name, h in zip(BRANCHES, heads):
                mods, inp = h[i], x
                if self.use_predecessors and PREDECESSORS[name]:
                    preds = [outputs[k] / DEP_NORM if k == "dep" else outputs[k]
                             for k in PREDECESSORS[name]]
                    inp = torch.cat([x] + [p.detach() for p in preds], 1)
                if name == "dep" and not self.common_head:
                    emb = run(mods[0], inp, plan)
                    outputs[name] = run(mods[1:], emb, plan)
                else:
                    outputs[name] = run(mods, inp, plan)
            ys.append(torch.cat([outputs[n] for n in BRANCHES], 1))
            embs.append(emb)
        return ys, embs

    def _sparse_forward_feat(self, xs, heads) -> List[torch.Tensor]:
        ys = []
        for i, x in enumerate(xs):
            B, _, H, W = x.shape
            cls_map = run(heads[0][i], x, None)  # dense: it drives the top-k
            K = min(SPARSE_K, H * W)
            if 2 * K * self.k2 * self.k2 >= H * W:
                ys.append(torch.cat([cls_map] + [run(h[i], x, None) for h in heads[1:]], 1))
                continue
            idx = candidates(cls_map, K)  # (B, K)
            reg = self.patch_regression(x, [h[i] for h in heads[1:]], idx)
            dense = torch.zeros((B, reg.shape[-1], H * W), dtype=reg.dtype, device=reg.device)
            dense.scatter_(2, idx[:, None, :].expand(-1, reg.shape[-1], -1), reg.transpose(1, 2))
            ys.append(torch.cat([cls_map, dense.reshape(B, -1, H, W)], 1))
        return ys

    def patch_regression(self, x: torch.Tensor, regs: Sequence[nn.Sequential],
                         idx: torch.Tensor) -> torch.Tensor:
        """The regression branches ``regs`` of one scale at the anchors
        ``idx`` (B, K) of the map ``x`` (B, C, H, W), from one patch per
        anchor: (B, K, sum of the branches' outputs)."""
        k1, k2 = self.k1, self.k2
        pad = k1 // 2 + k2 // 2
        P = 2 * pad + 1
        B, C, H, W = x.shape
        K = idx.shape[1]
        yi, xi = idx // W, idx % W
        Hp, Wp = H + 2 * pad, W + 2 * pad
        # window rows and cols in padded coordinates: centre (yi + pad) + d - pad
        d = torch.arange(P, device=x.device)
        rows = yi[:, :, None, None] + d[:, None]  # (B, K, P, 1)
        flat = (rows * Wp + xi[:, :, None, None] + d).reshape(B, 1, -1)
        xpad = F.pad(x, (pad, pad, pad, pad)).reshape(B, C, Hp * Wp)
        patches = xpad.gather(2, flat.expand(B, C, -1)).reshape(B, C, K, P, P)
        patches = patches.transpose(1, 2).reshape(B * K, C, P, P)

        w1 = torch.cat([r[0].conv.weight for r in regs])
        a1, b1 = (torch.cat(t) for t in zip(*(_affine(r[0].bn) for r in regs)))
        h1 = F.conv2d(patches, w1)  # VALID: (B*K, sum mid, k2, k2)
        h1 = F.silu(h1 * a1[:, None, None] + b1[:, None, None])
        # the dense conv2 zero-pads conv1's output map: zero the window
        # positions that fall outside the map, as the border anchors need
        du = torch.arange(k2, device=x.device) - k2 // 2
        r_ok = ((yi[:, :, None] + du) >= 0) & ((yi[:, :, None] + du) < H)
        c_ok = ((xi[:, :, None] + du) >= 0) & ((xi[:, :, None] + du) < W)
        inmap = (r_ok[:, :, :, None] & c_ok[:, :, None, :]).reshape(B * K, 1, k2, k2)
        h1 = torch.where(inmap, h1, 0.0)

        mids = [r[0].conv.out_channels for r in regs]
        w2s = [r[1].conv.weight for r in regs]  # (mid2, mid, k2, k2)
        ab2 = [_affine(r[1].bn) for r in regs]
        if len(set(mids)) == 1 and len({w.shape[0] for w in w2s}) == 1:
            # uniform branch widths (the shipped configs): one contraction
            g = len(regs)
            z = torch.einsum("pgmyx,gnmyx->pgn", h1.reshape(B * K, g, mids[0], k2, k2),
                             torch.stack(w2s))
            a2 = torch.stack([a for a, _ in ab2])
            b2 = torch.stack([b for _, b in ab2])
            h2s = F.silu(z * a2 + b2).unbind(1)  # g x (B*K, mid2)
        else:
            h2s = [F.silu(torch.einsum("pmyx,nmyx->pn", h, w2) * a2 + b2)
                   for h, w2, (a2, b2) in zip(h1.split(mids, 1), w2s, ab2)]
        outs = [h @ r[2].weight.flatten(1).t() + r[2].bias for h, r in zip(h2s, regs)]
        return torch.cat(outs, -1).reshape(B, K, -1)

    def forward(self, xs: Sequence[torch.Tensor], one2many: bool = True,
                sparse: bool = False, plan=None) -> Dict[str, List]:
        """``one2many=False``: the serving output {"one2one": maps}; with
        ``sparse`` the one-to-one regression branches run on the top-K
        patches (eval only; outside ``sparse_ok`` and under an int8 ``plan``
        the dense head runs).
        Otherwise {"one2many", "one2one"} maps, the dep embeddings
        {"o2m_embs", "o2o_embs"}, and with a DepthPredictor its (logits,
        depth, embeddings) as ``depth_maps``."""
        xs = list(xs[: self.nl])
        # the one-to-one branches train on detached features (JAX's stop_gradient)
        xs_det = [x.detach() for x in xs]
        if sparse and self.training:
            raise ValueError("the sparse 3D head serves eval only")
        if sparse and self.sparse_ok and plan is None:
            one2one, o2o_embs = self._sparse_forward_feat(xs_det, self.o2o_heads()), [None] * len(xs)
        else:
            one2one, o2o_embs = self._forward_feat(xs_det, self.o2o_heads(), plan)
        if not one2many:
            return {"one2one": one2one}
        one2many_maps, o2m_embs = self._forward_feat(xs, list(self.o2m_heads), plan)
        out = {"one2many": one2many_maps, "one2one": one2one, "o2m_embs": o2m_embs,
               "o2o_embs": o2o_embs}
        if hasattr(self, "fgdm_predictor"):
            out["depth_maps"] = self.fgdm_predictor(xs)
        return out


class DepthPredictor(nn.Module):
    """MonoDETR's foreground depth-map head (port of the JAX
    ``DepthPredictor``): P3 downsampled, P4 projected and P5 upsampled
    (bilinear, half-pixel centres) to P4's grid, each through GroupNorm(32),
    averaged; two conv + GroupNorm + ReLU stages; (D + 1)-bin LID depth
    logits and their softmax-weighted depth (the softmax in float32).
    ``depth_head`` indices 2 and 5 are the parameter-free ReLUs."""

    def __init__(self, ch: Sequence[int], depth_bins: int = 80, depth_min: float = 1.0,
                 depth_max: float = 70.0, hidden: int = 128):
        super().__init__()
        bin_size = 2 * (depth_max - depth_min) / (depth_bins * (1 + depth_bins))
        idx = np.arange(depth_bins, dtype=np.float32)
        bin_value = (idx + 0.5) ** 2 * bin_size / 2 - bin_size / 8 + depth_min
        self.register_buffer("depth_bin_values", torch.from_numpy(
            np.concatenate([bin_value, [depth_max]]).astype(np.float32)), persistent=False)
        d = hidden

        def gn():
            return nn.GroupNorm(32, d, eps=1e-5)

        self.downsample = nn.Sequential(nn.Conv2d(ch[0], d, 3, 2, 1), gn())
        self.proj = nn.Sequential(nn.Conv2d(ch[1], d, 1), gn())
        self.upsample = nn.Sequential(nn.Conv2d(ch[2], d, 1), gn())
        self.depth_head = nn.Sequential(nn.Conv2d(d, d, 3, 1, 1), gn(), nn.ReLU(),
                                        nn.Conv2d(d, d, 3, 1, 1), gn(), nn.ReLU())
        self.depth_classifier = nn.Conv2d(d, depth_bins + 1, 1)

    def forward(self, xs: Sequence[torch.Tensor]):
        """-> (logits (B, D + 1, H, W), depth (B, H, W), embeddings (B, hidden, H, W))
        on P4's grid. The layers compute in float32 whatever the input's
        dtype (``promoted``: the JAX layers have flax's default dtype)."""
        src_8 = promoted(self.downsample, xs[0])
        src_16 = promoted(self.proj, xs[1])
        p5 = F.interpolate(xs[2], size=src_16.shape[-2:], mode="bilinear", align_corners=False)
        src_32 = promoted(self.upsample, p5)
        src = (src_8 + src_16 + src_32) / 3
        emb = self.depth_head[:3](src)
        logits = self.depth_classifier(self.depth_head[3:](emb))
        probs = F.softmax(logits.float(), 1)
        depth = (probs * self.depth_bin_values[:, None, None]).sum(1)
        return logits, depth, emb


@torch.no_grad()
def detect3d_bias_init(head: V10Detect3d, nc: int, strides: Sequence[int],
                       rng: Optional[np.random.Generator] = None) -> V10Detect3d:
    """The 3D trainer's head init, in place: per scale, the class bias prior
    for 1280x384 inputs, s2d bias 6, o2d/o3d/s3d biases 0, the s3d kernel
    from N(0, 0.05), the dep bias 45/25/10 and the dep kernel uniform in a
    per-scale range; then the one-to-many branches become exact copies of
    the one-to-one ones (parameters; BN statistics stay). The kernels are
    drawn from ``rng`` (default ``np.random.default_rng(0)``) in the JAX
    package's order and flax layout (kH, kW, I, O), then moved to OIHW, so
    that the same numbers land in the same weights."""
    rng = np.random.default_rng(0) if rng is None else rng
    nl = len(strides)
    deps = {1: [40.0], 2: [45.0, 20.0], 3: [45.0, 25.0, 10.0]}[nl]
    ranges = {1: [(-3.5, 3.5)], 2: [(-2, 2), (-2, 2)], 3: [(-2, 2), (-1.5, 1.5), (-1, 1)]}[nl]

    def draw(conv: nn.Conv2d, sample) -> None:
        o, i, kh, kw = conv.weight.shape
        w = sample((kh, kw, i, o)).astype(np.float32).transpose(3, 2, 0, 1)
        conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(w)))

    for i, s in enumerate(strides):
        final = {name: getattr(head, name)[i][-1] for name in BRANCHES}
        final["cls"].bias.fill_(math.log(5 / nc / ((1280 / s) * (384 / s))))
        final["s2d"].bias.fill_(6.0)
        for name in ("o2d", "o3d", "s3d"):
            final[name].bias.zero_()
        draw(final["s3d"], lambda shape: rng.normal(0.0, 0.05, shape))
        final["dep"].bias.fill_(deps[i])
        lo, hi = ranges[i]
        draw(final["dep"], lambda shape: rng.uniform(lo, hi, shape))
    for o2o, o2m in zip(head.o2o_heads(), head.o2m_heads):
        for p_o, p_m in zip(o2o.parameters(), o2m.parameters()):
            p_m.copy_(p_o)
    return head


def _affine(bn: nn.BatchNorm2d):
    """Eval BatchNorm as y = x * a + b (float32)."""
    a = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    return a, bn.bias - bn.running_mean * a
