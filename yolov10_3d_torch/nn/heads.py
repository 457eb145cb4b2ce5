"""Detection heads (port of ``yolov10_3d_tpu/nn/heads.py``): YOLOv10's
NMS-free ``V10Detect`` and the v8 family's ``Detect``, ``Segment``, ``Pose``
and ``OBB``.

Each head returns raw per-scale NCHW maps (B, 4*reg_max + nc, H, W), in the
JAX head's list or dict; the decode, top-k and NMS live in
``ops/postprocess.py`` and ``ops/nms.py``. The DFL has no parameters.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
from torch import nn

from .modules import Conv, Proto, run

REG_MAX = 16


def _box_branch(c_in: int, c2: int, reg_max: int) -> nn.Sequential:
    """Box branch: Conv3x3, Conv3x3, 1x1 conv -> 4*reg_max."""
    return nn.Sequential(Conv(c_in, c2, 3), Conv(c2, c2, 3), nn.Conv2d(c2, 4 * reg_max, 1))


def _v10_cls_branch(c_in: int, c3: int, nc: int) -> nn.Sequential:
    """Lightweight cls branch: two (dw3x3 + pw1x1) stages, then a 1x1 conv."""
    return nn.Sequential(
        nn.Sequential(Conv(c_in, c_in, 3, g=c_in), Conv(c_in, c3, 1)),
        nn.Sequential(Conv(c3, c3, 3, g=c3), Conv(c3, c3, 1)),
        nn.Conv2d(c3, nc, 1),
    )


def _branch(c_in: int, c_mid: int, c_out: int) -> nn.Sequential:
    """Conv3x3, Conv3x3, 1x1 conv -> ``c_out`` (the v8 heads' cls and extra branches)."""
    return nn.Sequential(Conv(c_in, c_mid, 3), Conv(c_mid, c_mid, 3), nn.Conv2d(c_mid, c_out, 1))


class Detect(nn.Module):
    """YOLOv8's anchor-free DFL head: a list of per-scale (B, 4*reg_max + nc,
    H, W) maps. ``one2many`` is accepted and ignored (one branch)."""

    def __init__(self, nc: int, ch: Sequence[int]):
        super().__init__()
        self.nc = nc
        self.nl = len(ch)
        c2 = max(16, ch[0] // 4, REG_MAX * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(_box_branch(x, c2, REG_MAX) for x in ch)
        self.cv3 = nn.ModuleList(_branch(x, c3, nc) for x in ch)

    def det(self, xs, plan) -> List[torch.Tensor]:
        return [torch.cat([run(self.cv2[i], x, plan), run(self.cv3[i], x, plan)], 1)
                for i, x in enumerate(xs)]

    def extra(self, xs, plan) -> List[torch.Tensor]:
        """The per-scale maps of the head's third branch (``cv4``)."""
        return [run(self.cv4[i], x, plan) for i, x in enumerate(xs)]

    def forward(self, xs: Sequence[torch.Tensor], one2many: bool = True, plan=None):
        return self.det(xs, plan)


class Segment(Detect):
    """Detect + mask coefficients (``cv4``, ``nm`` a scale) + prototype masks
    (``proto``, at twice the first scale's resolution): {"det", "mask_coefs",
    "protos"}."""

    def __init__(self, nc: int, ch: Sequence[int], nm: int = 32, npr: int = 256):
        super().__init__(nc, ch)
        self.nm, self.npr = nm, npr
        c4 = max(ch[0] // 4, nm)
        self.cv4 = nn.ModuleList(_branch(x, c4, nm) for x in ch)
        self.proto = Proto(ch[0], npr, nm)

    def forward(self, xs: Sequence[torch.Tensor], one2many: bool = True, plan=None):
        p = self.proto(xs[0], plan)
        return {"det": self.det(xs, plan), "mask_coefs": self.extra(xs, plan), "protos": p}


class Pose(Detect):
    """Detect + raw keypoint maps (``cv4``, nk * nd a scale): {"det", "kpts"}."""

    def __init__(self, nc: int, ch: Sequence[int], kpt_shape: Sequence[int] = (17, 3)):
        super().__init__(nc, ch)
        self.kpt_shape = tuple(kpt_shape)
        self.nk = self.kpt_shape[0] * self.kpt_shape[1]
        c4 = max(ch[0] // 4, self.nk)
        self.cv4 = nn.ModuleList(_branch(x, c4, self.nk) for x in ch)

    def forward(self, xs: Sequence[torch.Tensor], one2many: bool = True, plan=None):
        return {"det": self.det(xs, plan), "kpts": self.extra(xs, plan)}


class OBB(Detect):
    """Detect + raw angle maps (``cv4``, ``ne`` a scale; decoded by
    ``ops/postprocess.py`` ``decode_obb_angle``): {"det", "angle"}."""

    def __init__(self, nc: int, ch: Sequence[int], ne: int = 1):
        super().__init__(nc, ch)
        self.ne = ne
        c4 = max(ch[0] // 4, ne)
        self.cv4 = nn.ModuleList(_branch(x, c4, ne) for x in ch)

    def forward(self, xs: Sequence[torch.Tensor], one2many: bool = True, plan=None):
        return {"det": self.det(xs, plan), "angle": self.extra(xs, plan)}


class V10Detect(nn.Module):
    """Dual-assignment head: one2many (training) and one2one (serving) branches.

    All four branch lists are held so that a full state_dict loads strictly.
    With ``one2many=False`` (serving) only one2one runs.
    """

    def __init__(self, nc: int, ch: Sequence[int]):
        super().__init__()
        self.nc = nc
        self.nl = len(ch)
        c2 = max(16, ch[0] // 4, REG_MAX * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(_box_branch(x, c2, REG_MAX) for x in ch)
        self.cv3 = nn.ModuleList(_v10_cls_branch(x, c3, nc) for x in ch)
        self.one2one_cv2 = nn.ModuleList(_box_branch(x, c2, REG_MAX) for x in ch)
        self.one2one_cv3 = nn.ModuleList(_v10_cls_branch(x, c3, nc) for x in ch)

    @staticmethod
    def _forward_feat(xs, cv2, cv3, plan) -> List[torch.Tensor]:
        return [torch.cat([run(cv2[i], x, plan), run(cv3[i], x, plan)], 1) for i, x in enumerate(xs)]

    def forward(self, xs: Sequence[torch.Tensor], one2many: bool = True, plan=None
                ) -> Dict[str, List[torch.Tensor]]:
        # one2one trains on detached features (the JAX stop_gradient)
        one2one = self._forward_feat(
            [x.detach() for x in xs], self.one2one_cv2, self.one2one_cv3, plan
        )
        if not one2many:
            return {"one2one": one2one}
        return {"one2many": self._forward_feat(xs, self.cv2, self.cv3, plan), "one2one": one2one}


@torch.no_grad()
def detect_bias_init(head: V10Detect, nc: int, strides: Sequence[int]) -> V10Detect:
    """The head's training init, in place (the JAX ``detect_bias_init``): each
    box branch's last bias 1.0, each class branch's log(5 / nc / (640 / s)^2);
    then the one2one branches take copies of the one2many parameters, so
    that both start identical. Running statistics are not copied."""
    for i, s in enumerate(strides):
        head.cv2[i][2].bias.fill_(1.0)
        head.cv3[i][2].bias.fill_(math.log(5 / nc / (640 / s) ** 2))
    for src, dst in ((head.cv2, head.one2one_cv2), (head.cv3, head.one2one_cv3)):
        for p_src, p_dst in zip(src.parameters(), dst.parameters()):
            p_dst.copy_(p_src)
    return head
