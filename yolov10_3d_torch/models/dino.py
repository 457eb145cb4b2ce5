"""DINOv2 depth teacher (port of ``yolov10_3d_tpu/models/dino.py``): a DINOv2
ViT backbone (patch 14, a class token, LayerScale, the position embedding
resized to the input's patch grid) and the linear depth head, frozen, the
teacher of the 3D distillation losses (``train/distill.py``) and of
``use_dino_depth`` validation.

Parameters carry torch.hub dinov2's own names (``cls_token``,
``pos_embed``, ``mask_token``, ``patch_embed.proj.*``,
``blocks.{i}.norm1.*``, ``.attn.qkv.*``, ``.attn.proj.*``, ``.ls1.gamma``,
``.mlp.fc1.*``, ..., ``norm.*``), so a public ``dinov2_vits14`` state dict
loads into ``DinoDepther.backbone`` and the reference ``DinoDepther.save()``
layout (``backbone.*`` + ``head.*``) into a ``DinoDepther``.
``load_dino_state_dict`` reads such a file (``.pt`` or ``.npz``), with or
without its head.

Numerics as the JAX module: attention as q kᵀ / sqrt(head dim), a softmax,
then v; LayerNorm eps 1e-6; exact-erf GELU; the head's BatchNorm eps 1e-5
(flax's). Every resize is ``jax.image.resize(..., "bilinear")`` with its
own weights (``ops/preprocess.py`` ``resize_bilinear``: half-pixel centres,
antialiased where it shrinks). The teacher runs in float32 with autocast
off and no gradient.

Teacher contract: ``teacher(imgs) -> (depth (B, H, W), embeddings (B, Ct,
Hp, Wp))`` for imgs (B, 3, H, W) float in [0, 1] on the teacher's device.
"""

from __future__ import annotations

import logging
import math
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.preprocess import resize_bilinear

LOGGER = logging.getLogger(__name__)

# torch-hub dinov2 configs
DINOV2_ARCHS = {
    "small": dict(embed_dim=384, depth=12, num_heads=6),
    "base": dict(embed_dim=768, depth=12, num_heads=12),
    "large": dict(embed_dim=1024, depth=24, num_heads=16),
    "giant": dict(embed_dim=1536, depth=40, num_heads=24),
}
# ImageNet normalisation of 0..255 pixels
_MEAN = (123.675, 116.28, 103.53)
_STD = (58.395, 57.12, 57.375)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        hd = C // self.num_heads
        q, k, v = self.qkv(x).reshape(B, N, 3, self.num_heads, hd).unbind(2)  # (B, N, H, hd)
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(hd)
        y = torch.einsum("bhnm,bmhd->bnhd", attn.softmax(-1), v)
        return self.proj(y.reshape(B, N, C))


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """Pre-norm block: x += ls1(attn(norm1 x)); x += ls2(mlp(norm2 x))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch_size: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, patch_size)


class DinoV2ViT(nn.Module):
    """DINOv2 ViT backbone. ``forward(x, out_indices)`` returns the blocks at
    ``out_indices`` through the final LayerNorm, the class token dropped,
    as maps (B, C, H // 14, W // 14): ``get_intermediate_layers(n,
    reshape=True, norm=True)``. ``mask_token`` is dinov2's (unused here)."""

    def __init__(self, embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 patch_size: int = 14, mlp_ratio: float = 4.0, pretrain_grid: int = 37):
        super().__init__()
        self.embed_dim, self.patch_size, self.pretrain_grid = embed_dim, patch_size, pretrain_grid
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, pretrain_grid ** 2 + 1, embed_dim))
        self.mask_token = nn.Parameter(torch.zeros(1, embed_dim))
        self.patch_embed = PatchEmbed(embed_dim, patch_size)
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, mlp_ratio) for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def patch_pos(self, hp: int, wp: int) -> torch.Tensor:
        """The patch position embedding resized from the 37x37 grid it was
        trained at to (hp, wp): (1, hp * wp, C)."""
        g, C = self.pretrain_grid, self.embed_dim
        grid = self.pos_embed[:, 1:].reshape(1, g, g, C).permute(0, 3, 1, 2)
        return resize_bilinear(grid, (hp, wp)).flatten(2).transpose(1, 2)

    def forward(self, x: torch.Tensor, out_indices: Sequence[int] = (2, 5, 8, 11)
                ) -> List[torch.Tensor]:
        B, _, H, W = x.shape
        hp, wp = H // self.patch_size, W // self.patch_size
        x = self.patch_embed.proj(x).flatten(2).transpose(1, 2)  # (B, hp * wp, C)
        x = x + self.patch_pos(hp, wp)
        cls = (self.cls_token + self.pos_embed[:, :1]).expand(B, -1, -1)
        x = torch.cat([cls, x], 1)
        want = {int(i) for i in out_indices}
        outs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in want:
                outs.append(x)
        return [self.norm(o)[:, 1:].transpose(1, 2).reshape(B, self.embed_dim, hp, wp)
                for o in outs]


class DinoDepthHead(nn.Module):
    """The linear depth head: BatchNorm over the concatenated layers, a 1x1
    conv to one channel, ReLU. Returns (depth (B, Hp, Wp), the concatenated
    layers = the embeddings)."""

    def __init__(self, channels: int):
        super().__init__()
        self.bn = nn.BatchNorm2d(channels, eps=1e-5)
        self.conv_depth = nn.Conv2d(channels, 1, 1)

    def forward(self, feats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        f = torch.cat(list(feats), 1)
        return F.relu(self.conv_depth(self.bn(f))[:, 0]), f

    @torch.no_grad()
    def seed(self, seed: int) -> "DinoDepthHead":
        """Seeded weights: the conv from N(0, 1/fan_in), its bias 0, the
        BatchNorm the identity."""
        w = self.conv_depth.weight
        w.copy_(torch.randn(w.shape, generator=torch.Generator().manual_seed(seed))
                / math.sqrt(w[0].numel()))
        self.conv_depth.bias.zero_()
        self.bn.reset_parameters()
        return self


class DinoDepther(nn.Module):
    """Backbone + head; the normalisation and the resizes are the teacher's
    (``DinoTeacher``). ``arch_override`` changes widths and depth (a student-
    matched embedding width, or the tests' tiny configs)."""

    def __init__(self, backbone_size: str = "small", out_indices: Sequence[int] = (2, 5, 8, 11),
                 arch_override: Optional[Dict[str, int]] = None):
        super().__init__()
        arch = dict(DINOV2_ARCHS[backbone_size], **(arch_override or {}))
        self.out_indices = tuple(int(i) for i in out_indices)
        self.backbone = DinoV2ViT(**arch)
        layers = {i for i in self.out_indices if 0 <= i < arch["depth"]}  # the blocks there are
        self.head = DinoDepthHead(arch["embed_dim"] * len(layers))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.head(self.backbone(x, self.out_indices))

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "DinoDepther":
        """Seeded random weights: the tokens and position embedding from
        N(0, 0.02), linear and conv weights from N(0, 1/fan_in), biases 0,
        LayerNorms and BatchNorm identity, LayerScale 1e-5."""
        g = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith(("cls_token", "pos_embed", "mask_token")):
                p.copy_(torch.randn(p.shape, generator=g) * 0.02)
            elif name.endswith("gamma"):
                p.fill_(1e-5)
            elif p.dim() >= 2:
                p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(p[0].numel()))
            elif ".norm" in name or name.startswith("backbone.norm") or name == "head.bn.weight":
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            else:
                p.zero_()
        self.head.bn.reset_running_stats()
        return self


class DinoTeacher:
    """The frozen teacher callable around a ``DinoDepther`` on its device:
    ``teacher(imgs)`` -> (depth (B, H, W), embeddings (B, Ct, Hp, Wp)) for
    imgs (B, 3, H, W) float in [0, 1]: x 255, the ImageNet mean and std, a
    resize to the largest multiple of 14 not above (H, W), the model, the
    depth resized back to (H, W). Float32, autocast off, no gradient."""

    def __init__(self, model: DinoDepther):
        self.model = model.eval().requires_grad_(False)
        p = next(model.parameters())
        self.mean = torch.tensor(_MEAN, device=p.device)[:, None, None]
        self.std = torch.tensor(_STD, device=p.device)[:, None, None]

    @torch.no_grad()
    def __call__(self, imgs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.autocast(imgs.device.type, enabled=False):
            x = imgs.float()
            B, _, H, W = x.shape
            x = (x * 255.0 - self.mean) / self.std
            x = resize_bilinear(x, (H - H % 14, W - W % 14))
            depth, emb = self.model(x)
            depth = resize_bilinear(depth[:, None], (H, W))[:, 0]
        return depth, emb


def make_dino_teacher(model: Optional[DinoDepther] = None, backbone_size: str = "small",
                      out_indices: Sequence[int] = (2, 5, 8, 11), seed: int = 0,
                      arch_override: Optional[Dict[str, int]] = None,
                      device: Union[str, torch.device] = "cuda") -> DinoTeacher:
    """The frozen teacher of ``model`` (default: a ``DinoDepther`` of these
    settings with seeded random weights) on ``device``."""
    if model is None:
        model = DinoDepther(backbone_size, out_indices, arch_override).init_weights(seed)
    return DinoTeacher(model.to(resolve_device(device)))


def _read_state_dict(path) -> Dict[str, torch.Tensor]:
    path = str(path)
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(np.array(z[k])) for k in z.files}
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(raw, Mapping) and "state_dict" in raw:
        raw = raw["state_dict"]
    return {k: torch.as_tensor(v) for k, v in raw.items()}


def load_dino_state_dict(sd: Mapping[str, torch.Tensor], seed: int = 0) -> DinoDepther:
    """A ``DinoDepther`` (on the CPU) from a state dict in the reference's
    ``save()`` layout (``backbone.*`` + ``head.*``) or a bare dinov2
    backbone's (torch.hub names). The arch is the one whose width is
    ``cls_token``'s (``ValueError`` if none is); ``mask_token`` may be
    absent. Without ``head.*`` keys, or with keys the head does not know,
    the head keeps its seeded random weights, with a warning (the
    embeddings, the distillation signal, are the backbone's alone)."""
    bb = {k[len("backbone."):]: v for k, v in sd.items() if k.startswith("backbone.")}
    if not bb:
        bb = dict(sd)  # a bare dinov2 backbone
    dim = int(bb["cls_token"].shape[-1])
    size = next((n for n, a in DINOV2_ARCHS.items() if a["embed_dim"] == dim), None)
    if size is None:
        raise ValueError(f"dino_path embed_dim {dim} matches no DINOv2 arch "
                         f"({ {n: a['embed_dim'] for n, a in DINOV2_ARCHS.items()} })")
    model = DinoDepther(size)
    missing, unexpected = model.backbone.load_state_dict(bb, strict=False)
    if unexpected or set(missing) - {"mask_token"}:
        raise KeyError(f"dino backbone keys: missing {sorted(missing)}, "
                       f"unexpected {sorted(unexpected)}")
    head = {k[len("head."):]: v for k, v in sd.items() if k.startswith("head.")}
    if not head:
        model.head.seed(seed)
        LOGGER.warning(f"the dino state dict has no head.* keys: the depth head keeps seeded "
                       f"random weights (seed {seed}); the embeddings are unaffected")
    else:
        try:
            model.head.load_state_dict(
                {k: head[k] for k in ("bn.weight", "bn.bias", "bn.running_mean",
                                      "bn.running_var", "conv_depth.weight", "conv_depth.bias")},
                strict=False)
        except (KeyError, RuntimeError) as e:
            model.head.seed(seed)
            LOGGER.warning(f"dino head keys not recognized ({e}); the depth head keeps seeded "
                           "random weights (the embeddings are unaffected)")
    LOGGER.info(f"dino teacher: dinov2 {size}")
    return model


def load_dino_teacher(path, device: Union[str, torch.device] = "cuda") -> DinoTeacher:
    """``dino_path`` -> the frozen teacher on ``device``: a ``.pt`` (a state
    dict, ``torch.load(weights_only=True)``, optionally under
    ``"state_dict"``) or an ``.npz`` of the same keys."""
    return make_dino_teacher(load_dino_state_dict(_read_state_dict(Path(path))), device=device)
