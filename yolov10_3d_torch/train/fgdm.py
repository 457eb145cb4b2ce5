"""Foreground depth-map loss (port of ``yolov10_3d_tpu/train/fgdm.py``): a
focal classification over 80 LID depth bins, foreground pixels weighted
against the background. The depth logits are the port's NCHW maps
(B, D + 1, H, W).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .loss import ONE_PROCESS


def bin_depths(depth_map: torch.Tensor, depth_min: float, depth_max: float,
               num_bins: int = 80, mode: str = "LID") -> torch.Tensor:
    """Depth map -> integer bin indices; out of range or invalid -> num_bins."""
    if mode == "UD":
        bin_size = (depth_max - depth_min) / num_bins
        indices = (depth_map - depth_min) / bin_size
    elif mode == "LID":
        bin_size = 2 * (depth_max - depth_min) / (num_bins * (1 + num_bins))
        indices = -0.5 + 0.5 * torch.sqrt(1 + 8 * (depth_map - depth_min) / bin_size)
    elif mode == "SID":
        indices = (num_bins * (torch.log(1 + depth_map) - math.log(1 + depth_min))
                   / (math.log(1 + depth_max) - math.log(1 + depth_min)))
    else:
        raise NotImplementedError(mode)
    invalid = (indices < 0) | (indices > num_bins) | ~torch.isfinite(indices)
    return torch.where(invalid, float(num_bins), indices).to(torch.int32)


def focal_ce(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25,
             gamma: float = 2.0, dim: int = -1) -> torch.Tensor:
    """Multi-class focal loss on the logits along ``dim``; targets are the
    integer classes (the logits' shape without ``dim``)."""
    logp = F.log_softmax(logits.float(), dim)
    tgt = targets.long().clamp(0, logits.shape[dim] - 1).unsqueeze(dim)
    logp_t = logp.gather(dim, tgt).squeeze(dim)
    p_t = torch.exp(logp_t)
    return -alpha * (1 - p_t) ** gamma * logp_t


def foreground_depth_map_loss(
    depth_logits: torch.Tensor,  # (B, D + 1, H, W) from DepthPredictor
    depth_maps: torch.Tensor,  # (B, Hd, Wd) per-pixel fg depth (0 = background)
    *,
    depth_min: float = 1.0,
    depth_max: float = 120.0,
    num_bins: int = 80,
    alpha: float = 0.25,
    gamma: float = 2.0,
    fg_weight: float = 13.0,
    bg_weight: float = 1.0,
    ranks=ONE_PROCESS,
) -> torch.Tensor:
    """Focal loss over the LID bins with foreground/background weights, the
    sum over the logits' grid divided by its pixel count (the global
    batch's across the data-parallel ranks of ``ranks``)."""
    B, _, H, W = depth_logits.shape
    # nearest-downsample the GT depth map to the logits grid; the sample
    # positions are computed in float32, as the JAX package computes them
    Hd, Wd = depth_maps.shape[1], depth_maps.shape[2]
    dev = depth_maps.device
    ys = (torch.arange(H, device=dev, dtype=torch.float32) * torch.tensor(
        Hd / H, dtype=torch.float32, device=dev)).long()
    xs = (torch.arange(W, device=dev, dtype=torch.float32) * torch.tensor(
        Wd / W, dtype=torch.float32, device=dev)).long()
    dm = depth_maps[:, ys][:, :, xs]  # (B, H, W)

    target = bin_depths(dm, depth_min, depth_max, num_bins)
    loss = focal_ce(depth_logits, target, alpha, gamma, dim=1)  # (B, H, W)
    weights = torch.where(dm > 0, fg_weight, bg_weight)
    return (loss * weights).sum() / (dm.numel() * ranks.world)
