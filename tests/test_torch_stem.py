"""The fused serving stem of the PyTorch port (``kernels/stem.py``, the route
``nn/modules.py`` ``Conv.fused_stem`` behind ``spd_serving``) on the CPU,
where it runs its plain twin; tests/test_torch_kernels.py holds the CUDA
kernel to the twin on the card.

Bars, and what this CPU run measured:
- the twin, with the stem's BatchNorm folded in, against JAX's ``Conv``
  with ``spd=True`` and ``spd="packed"`` (``ops/spd_stem.py``: the stem as a
  2x2 space-to-depth conv, then BN and SiLU) on the same weights and
  statistics: 2e-4 absolute (measured 1.7e-6; the folded BatchNorm and the
  packed contraction order differ by float reassociation);
- against the port's own unfused Conv (cuDNN's or the CPU's conv, BN,
  SiLU): 1e-5 + 1e-5 |y| (measured 1.4e-6 on outputs up to 3.6);
- the folded weights are rebuilt whenever the parameters or statistics
  change (``load_state_dict``, calibration, in-place edits, ``.to``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from yolov10_3d_tpu.nn import modules as JM
from yolov10_3d_tpu.ops.spd_stem import space_to_depth
from yolov10_3d_torch import YOLOv10
from yolov10_3d_torch.kernels import launch_counts
from yolov10_3d_torch.kernels.stem import STEM_CHANNELS, fold_bn, stem_conv_torch
from yolov10_3d_torch.nn import modules as M
from yolov10_3d_torch.utils.parity import calibrate


def _stem(C: int, seed: int) -> M.Conv:
    """A port stem with random weights and BatchNorm statistics."""
    g = torch.Generator().manual_seed(seed)
    conv = M.Conv(3, C, 3, 2).eval()
    with torch.no_grad():
        conv.conv.weight.copy_(torch.randn(conv.conv.weight.shape, generator=g) / 27**0.5)
        conv.bn.weight.copy_(0.5 + torch.rand(C, generator=g))
        conv.bn.bias.copy_(torch.randn(C, generator=g) * 0.3)
        conv.bn.running_mean.copy_(torch.randn(C, generator=g) * 0.2)
        conv.bn.running_var.copy_(0.2 + torch.rand(C, generator=g))
    return conv


def _jax_variables(conv: M.Conv):
    t = lambda a: jnp.asarray(a.detach().numpy())  # noqa: E731
    return {"params": {"conv": {"kernel": t(conv.conv.weight.permute(2, 3, 1, 0))},
                       "bn": {"scale": t(conv.bn.weight), "bias": t(conv.bn.bias)}},
            "batch_stats": {"bn": {"mean": t(conv.bn.running_mean),
                                   "var": t(conv.bn.running_var)}}}


@pytest.mark.parametrize("C", STEM_CHANNELS)
@pytest.mark.parametrize("spd", [True, "packed"])
def test_stem_twin_matches_jax_spd_conv(C, spd):
    conv = _stem(C, C)
    x = np.random.default_rng(C).uniform(size=(2, 32, 48, 3)).astype(np.float32)
    jconv = JM.Conv(C, 3, 2, spd=spd)
    xin = space_to_depth(jnp.asarray(x)) if spd == "packed" else jnp.asarray(x)
    want = np.asarray(jconv.apply(_jax_variables(conv), xin, train=False))
    w, b = fold_bn(conv.conv.weight, conv.bn)
    got = stem_conv_torch(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(), w, b)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("C,H,W", [(16, 64, 64), (32, 37, 53), (48, 1, 1), (64, 20, 7),
                                   (80, 33, 65)])
def test_fused_stem_matches_unfused_conv(C, H, W):
    """Odd sizes included: the output is ((H + 1) // 2, (W + 1) // 2)."""
    conv = _stem(C, H + W)
    x = torch.rand((2, 3, H, W), generator=torch.Generator().manual_seed(C))
    before = dict(launch_counts)
    with torch.no_grad():
        want = conv(x)
        got = conv.fused_stem(x)
    assert launch_counts == before  # the CPU runs the twin: no kernel launch counted
    assert got.shape == want.shape == (2, C, (H + 1) // 2, (W + 1) // 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_fold_cache_follows_the_parameters():
    """The folded weights are kept while nothing changes, and rebuilt after
    load_state_dict, an in-place edit of a statistic and calibration."""
    conv = _stem(32, 0)
    x = torch.rand((1, 3, 16, 16), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        conv.fused_stem(x)
        cached = conv.stem_cache
        conv.fused_stem(x)
        assert conv.stem_cache is cached
        conv.load_state_dict(_stem(32, 5).state_dict())
        torch.testing.assert_close(conv.fused_stem(x), conv(x), rtol=1e-5, atol=1e-5)
        assert conv.stem_cache is not cached
        conv.bn.running_var.mul_(4.0)
        torch.testing.assert_close(conv.fused_stem(x), conv(x), rtol=1e-5, atol=1e-5)

    model = YOLOv10("yolov10n.yaml", device="cpu").model
    x = torch.rand((2, 3, 64, 64), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        model(x, fast_eval=True, stem=True)  # folds the initial (identity) statistics
        before = model.model[0].stem_cache
    calibrate(model, x)
    stem = model.model[0]
    with torch.no_grad():
        model(x, fast_eval=True, stem=True)
        assert stem.stem_cache is not before
        torch.testing.assert_close(stem.fused_stem(x), stem(x), rtol=1e-5, atol=1e-5)


def test_fused_stem_is_eval_and_stem_only():
    conv = _stem(16, 0)
    x = torch.rand((1, 3, 8, 8))
    conv.train()
    with pytest.raises(RuntimeError, match="eval only"):
        conv.fused_stem(x)
    with pytest.raises(ValueError, match="3-channel 3x3 stride-2"):
        M.Conv(3, 16, 3, 1).eval().fused_stem(x)
    model = YOLOv10("yolov10n.yaml", device="cpu").model.train()
    with pytest.raises(RuntimeError, match="eval only"):
        model(torch.rand((1, 3, 64, 64)), stem=True)
