"""YOLOv10 NMS-free detection head (port of ``yolov10_3d_tpu/nn/heads.py``).

The head returns raw per-scale NCHW maps (B, 4*reg_max + nc, H, W); the
decode and top-k live in ``ops/postprocess.py``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
from torch import nn

from .modules import Conv, run

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
