"""The tile choice of the wgmma int8 convs (``kernels/int8.py`` ``conv_tiles``),
checked on the CPU against every conv that ``plan_int8`` routes to K3 or
``int8_conv_f32``: the kernel itself runs only on the card
(``tests/test_torch_kernels.py``), but its launch parameters are Python.
"""

import math

import pytest

from yolov10_3d_torch import YOLOv10
from yolov10_3d_torch.kernels import int8 as K8
from yolov10_3d_torch.nn.quant import Int8Config, plan_int8

WGMMA_N = set(range(8, 257, 8))  # m64nNk32 with s8 operands: N a multiple of 8 up to 256
WGMMA_ROUTES = ("int8_conv3x3_fused", "int8_conv_f32")


def _wgmma_convs(yaml: str, imgsz: int, stem: bool):
    """(name, route, B=1 GEMM (M, N, Krow), output pixels per image) of the
    plan's gated convs on the two wgmma routes."""
    model = YOLOv10(yaml, device="cpu").model
    plan = plan_int8(model, (imgsz, imgsz), Int8Config(), stem=stem)
    out = []
    for conv, route in plan.routes.items():
        if route not in WGMMA_ROUTES:
            continue
        c = conv.conv
        h = math.isqrt(plan.hw[conv])
        ks, s, p = c.kernel_size[0], c.stride[0], c.padding[0]
        ho = (h + 2 * p - ks) // s + 1
        kp = -(-c.in_channels // 4) * 4
        out.append((plan.names[conv], route, ho * ho, c.out_channels, ks * ks * kp))
    return out


@pytest.mark.parametrize("yaml", ["yolov10n.yaml", "yolov10s.yaml"])
@pytest.mark.parametrize("imgsz", [64, 640])
@pytest.mark.parametrize("stem", [True, False])
def test_conv_tiles_cover_the_plan(yaml, imgsz, stem):
    """For every K3 and int8_conv_f32 conv of the plan, at batch 1, 8 and 32:
    a compiled tile with a legal wgmma N, shared memory within the 227 KB a
    block may use, a grid within the launch limits and the wrappers'
    32-bit guards, and a K loop that covers the reduction exactly.
    ``stem=False`` adds the unfused stem (K = 4: the 4-byte gather)."""
    convs = _wgmma_convs(yaml, imgsz, stem)
    assert {r for _, r, *_ in convs} == set(WGMMA_ROUTES)
    for name, route, hw, N, Krow in convs:
        for B in (1, 8, 32):
            M = B * hw
            t = K8.conv_tiles(M, N, Krow)
            assert (t.bm, t.bn, t.stages) in K8.TILES, (name, t)
            assert t.bn in WGMMA_N and t.bm % 64 == 0 and t.stages >= 3
            assert t.bn <= max(32, -(-N // 32) * 32), (name, N, t)
            for f32_out in (False, True):
                assert K8.conv_smem_bytes(t, f32_out) <= K8.SMEM_MAX, (name, t)
            grid = (-(-M // t.bm), -(-N // t.bn))
            assert grid[0] < 2**31 and grid[1] <= 65535, (name, grid)
            assert M * N < 2**31 and M * max(Krow, N) < 2**31
            assert (t.k_tiles - 1) * K8.BK < Krow <= t.k_tiles * K8.BK, (name, Krow, t)


def test_conv_tiles_fill_the_card():
    """The largest tile whose grid gives each of the 132 SMs a block; below
    that, the one with the most blocks (BM 64 before 128)."""
    # layer 17 of YOLOv10-S at 640: 3x3 s2, 40x40 out, 128 -> 128
    assert K8.conv_tiles(32 * 1600, 128, 1152)[:3] == (128, 128, 3)  # 400 blocks
    assert K8.conv_tiles(8 * 1600, 128, 1152)[:3] == (128, 64, 4)  # 100 at 128x128
    assert K8.conv_tiles(1600, 128, 1152)[:3] == (64, 32, 4)  # 13 at 128x128
    # the 20x20 1x1s at batch 1 and the head's P5 box conv (K3)
    assert K8.conv_tiles(400, 512, 1024)[:3] == (64, 32, 4)  # 112 blocks
    assert K8.conv_tiles(400, 64, 4608) == (64, 32, 4, 36)
    # N = 32 (model.2) and N = 16 (yolov10n) take 32-wide tiles
    assert K8.conv_tiles(8 * 160 * 160, 32, 288)[:3] == (128, 32, 4)
    assert K8.conv_tiles(160 * 160, 16, 144)[:3] == (128, 32, 4)
    # a card with fewer SMs fills sooner
    assert K8.conv_tiles(8 * 1600, 128, 1152, sms=100)[:3] == (128, 128, 3)
    with pytest.raises(ValueError, match="empty"):
        K8.conv_tiles(0, 64, 128)
