"""The tile choice of the wgmma int8 convs (``kernels/int8.py`` ``conv_tiles``),
checked on the CPU against every conv that ``plan_int8`` routes to K3 or
``int8_conv_f32``: the kernel itself runs only on the card
(``tests/test_torch_kernels.py``), but its launch parameters are Python.
"""

import math

import pytest

from _torch_threads import torch_threads  # noqa: F401  (autouse)
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


def _k2_sites(yaml: str, imgsz: int):
    """(name, M per image, N, K) of the plan's K2 sites (1x1 stride-1 convs)."""
    model = YOLOv10(yaml, device="cpu").model
    plan = plan_int8(model, (imgsz, imgsz), Int8Config(), stem=True)
    return [(plan.names[conv], plan.hw[conv], conv.conv.out_channels,
             -(-conv.conv.in_channels // 4) * 4)
            for conv, route in plan.routes.items() if route == "int8_mm_fused"]


@pytest.mark.parametrize("yaml", ["yolov10n.yaml", "yolov10s.yaml"])
@pytest.mark.parametrize("imgsz", [64, 640])
def test_mm_tiles_cover_the_plan(yaml, imgsz):
    """For both K2 sites of the plan (SPPF.cv1, PSA ffn.0), at batch 1, 8
    and 32: a compiled tile with a legal wgmma N no wider than N needs,
    shared memory within the 227 KB a block may use, one block per tile in
    one wave of resident blocks or else a persistent grid of one block per
    SM (never more), and a K loop that covers the reduction."""
    sites = _k2_sites(yaml, imgsz)
    assert [n for n, *_ in sites] == ["model.9.cv1", "model.10.ffn.0"]
    for name, hw, N, K in sites:
        for B in (1, 8, 32):
            M = B * hw
            t = K8.mm_tiles(M, N, K)
            assert t[:3] in K8.MM_TILES, (name, t)
            assert t.bn in WGMMA_N and t.bm in (64, 128), (name, t)
            assert t.bn <= max(32, 1 << (N - 1).bit_length()), (name, N, t)
            assert K8.mm_smem_bytes(t) <= K8.SMEM_MAX, (name, t)
            tiles = -(-M // t.bm) * -(-N // t.bn)
            resident = K8.SMEM_SM // (K8.mm_smem_bytes(t) + 1024)
            assert t.grid == tiles <= K8.SMS * resident or t.grid == K8.SMS < tiles, (name, t)
            assert (t.k_tiles - 1) * K8.BK < K <= t.k_tiles * K8.BK, (name, K, t)
            assert M * N < 2**31


def test_mm_tiles_fill_the_card():
    """Within one wave of resident blocks, one tile a block: the largest
    tile that gives every SM a block, else the one with the most tiles;
    where none fits, the largest tile on one block per SM."""
    # SPPF.cv1 (K 512, N 256) and PSA ffn.0 (K 256, N 512) of YOLOv10-S at
    # 640 at batch 1, 8 and 32 (M = 400 B)
    assert K8.mm_tiles(400, 256, 512) == (64, 32, 4, 56, 4)
    assert K8.mm_tiles(400, 512, 256) == (64, 32, 4, 112, 2)
    assert K8.mm_tiles(3200, 256, 512) == (64, 64, 4, 200, 4)  # 3 blocks an SM
    assert K8.mm_tiles(3200, 512, 256) == (64, 128, 4, 200, 2)  # 2 blocks an SM
    assert K8.mm_tiles(12800, 256, 512) == (128, 256, 3, 100, 4)
    assert K8.mm_tiles(12800, 512, 256) == (128, 256, 3, K8.SMS, 2)  # 200 tiles: persistent
    assert K8.mm_tiles(12800, 512, 256, sms=200) == (128, 256, 3, 200, 2)
    # tiny and narrow shapes take the narrowest tile
    assert K8.mm_tiles(1, 3, 4) == (64, 32, 4, 1, 1)
    assert K8.mm_tiles(97, 40, 32) == (64, 32, 4, 4, 1)
    with pytest.raises(ValueError, match="empty"):
        K8.mm_tiles(0, 64, 128)


def test_k2_card_cases_reach_every_tile():
    """Shapes of the card test (tests/test_torch_kernels.py K2_CASES) make
    mm_tiles pick every tile K2 compiles, so each runs through the public
    wrapper on the card."""
    from test_torch_kernels import K2_CASES, K2_TILE_CASES

    assert set(K2_TILE_CASES) <= set(K2_CASES)
    assert {K8.mm_tiles(M, N, K)[:3] for M, K, N in K2_TILE_CASES} == set(K8.MM_TILES)
