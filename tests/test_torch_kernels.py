"""The port's hand-written CUDA kernels against their plain PyTorch twins.

Imports torch and the port only, so it also runs on the card, where JAX is
absent: ``python -m pytest --noconftest tests/test_torch_kernels.py``.
The tests that launch a kernel are marked ``cuda`` and skip without a GPU.
"""

import pytest
import torch

from yolov10_3d_torch.kernels import launch_counts, reset_launch_counts
from yolov10_3d_torch.kernels.decode import (
    decode_detect_cuda, decode_detect_flat, decode_detect_torch,
)

NC, REG_MAX = 80, 16
STRIDES = (8, 16, 32)
SMALL = [(8, 8), (4, 4), (2, 2)]
FULL = [(80, 80), (40, 40), (20, 20)]  # YOLOv10 at 640x640


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel is CUDA with no CPU mode; run on the card")
    return torch.device("cuda")


def test_decode_kernel_refuses_cpu_tensors():
    """No silent fallback: the kernel wrapper takes CUDA tensors only, and the
    dispatcher takes the twin for CPU tensors and nothing else."""
    x = torch.zeros((1, 4 * REG_MAX + NC, 84))
    with pytest.raises(ValueError, match="CUDA"):
        decode_detect_cuda(x, SMALL, STRIDES, NC)
    with pytest.raises(ValueError, match="unsupported device"):
        decode_detect_flat(x.to("meta"), SMALL, STRIDES, NC)
    before = launch_counts["decode_detect"]
    assert decode_detect_flat(x, SMALL, STRIDES, NC).shape == (1, 84, 4 + NC)
    assert launch_counts["decode_detect"] == before


def test_reset_launch_counts():
    launch_counts["decode_detect"] += 3
    reset_launch_counts()
    assert launch_counts == {"decode_detect": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("B,shapes", [(2, SMALL), (1, FULL), (3, [(5, 7), (3, 4)])])
def test_decode_kernel_matches_twin(cuda_device, B, shapes):
    """K1 against the twin on the same CUDA tensor. Bar: rtol 1e-5 with atol
    1e-5 on boxes and 1e-6 on scores, as tests/test_pallas_kernels.py holds
    the TPU kernel to its XLA twin; both round in the same order, so the gap
    is exp's last bit at most. The odd shapes leave a ragged last block."""
    A = sum(h * w for h, w in shapes)
    g = torch.Generator(device=cuda_device).manual_seed(B)
    x = torch.randn((B, 4 * REG_MAX + NC, A), generator=g, device=cuda_device) * 3
    before = launch_counts["decode_detect"]
    got = decode_detect_flat(x, shapes, STRIDES[: len(shapes)], NC)
    assert launch_counts["decode_detect"] == before + 1
    ref = decode_detect_torch(x, shapes, STRIDES[: len(shapes)], NC)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[..., :4], ref[..., :4], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[..., 4:], ref[..., 4:], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_decode_kernel_checks_inputs(cuda_device):
    x = torch.zeros((1, 4 * REG_MAX + NC, 84), device=cuda_device)
    with pytest.raises(TypeError):
        decode_detect_cuda(x.half(), SMALL, STRIDES, NC)
    with pytest.raises(ValueError, match="contiguous"):
        decode_detect_cuda(x.transpose(1, 2), SMALL, STRIDES, NC)
    with pytest.raises(ValueError, match="cover"):
        decode_detect_cuda(x, FULL, STRIDES, NC)
