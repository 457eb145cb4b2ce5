"""DCNv2 in the port (``ops/deform.py`` ``deform_conv2d``, ``nn/modules.py``
``DeformableConv2d`` and ``Conv(..., deform=True)``) against the JAX package's
``ops/deform.py`` and ``nn/modules.py`` on the CPU.

Inputs from numpy seeds: offsets of up to a few pixels, so that taps reach
outside the map (zero there), and masks in (0, 2). Bars: forward 1e-5 +
1e-5 |y| against JAX and against the brute-force float64 DCNv2 of JAX's own
test (``tests/test_deform.py`` ``_numpy_dcn``); gradients in the input, the
offsets, the mask and the weights against ``jax.grad``, rtol 2e-4 (plus
1e-6 of the gradient's largest element).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from test_deform import _numpy_dcn
from test_torch_predictor import jax_variables
from yolov10_3d_tpu.nn.modules import Conv as JaxConv
from yolov10_3d_tpu.ops.deform import deform_conv2d as jax_deform_conv2d
from yolov10_3d_torch.nn.modules import Conv, DeformableConv2d
from yolov10_3d_torch.ops.deform import deform_conv2d
from yolov10_3d_torch.utils.weights import load_flax_variables

B, H, W, C, O, K = 2, 9, 11, 6, 5, 3


def _case(seed, stride, pad):
    rng = np.random.default_rng(seed)
    Ho = (H + 2 * pad - K) // stride + 1
    Wo = (W + 2 * pad - K) // stride + 1
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    w = rng.normal(size=(K, K, C, O)).astype(np.float32) / 4
    off = (rng.normal(size=(B, Ho, Wo, 2 * K * K)) * 2.5).astype(np.float32)
    m = rng.uniform(0, 2, (B, Ho, Wo, K * K)).astype(np.float32)
    b = rng.normal(size=(O,)).astype(np.float32)
    return x, off, m, w, b


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _port_args(x, off, m, w, b):
    return (_nchw(x), _nchw(off), _nchw(m),
            torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))), torch.from_numpy(b))


@pytest.mark.parametrize("stride,pad", [(1, 0), (1, 1), (2, 0), (2, 1)])
def test_deform_conv2d_matches_jax(stride, pad):
    x, off, m, w, b = _case(stride * 10 + pad, stride, pad)
    want = np.asarray(jax.jit(functools.partial(
        jax_deform_conv2d, stride=(stride, stride), padding=(pad, pad)))(
            *map(jnp.asarray, (x, off, m, w, b))))
    got = deform_conv2d(*_port_args(x, off, m, w, b), stride=(stride, stride),
                        padding=(pad, pad)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    exact = _numpy_dcn(x.astype(np.float64), off, m, w.astype(np.float64), stride, pad) + b
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-5)
    # taps did reach outside the map
    base = np.arange(got.shape[1]) * stride - pad
    assert (base.min() + off[..., 0::2].min() < 0) and (base.max() + off[..., 0::2].max() > H)


@pytest.mark.parametrize("stride,pad", [(1, 1), (2, 0)])
def test_deform_conv2d_grads_match_jax(stride, pad):
    x, off, m, w, b = _case(100 + stride, stride, pad)
    cot = np.random.default_rng(7).normal(
        size=jax.eval_shape(functools.partial(
            jax_deform_conv2d, stride=(stride, stride), padding=(pad, pad)),
            *map(jnp.asarray, (x, off, m, w, b))).shape).astype(np.float32)

    def jloss(x, off, m, w, b):
        y = jax_deform_conv2d(x, off, m, w, b, stride=(stride, stride), padding=(pad, pad))
        return (y * cot).sum()

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, (x, off, m, w, b)))
    args = [a.requires_grad_() for a in _port_args(x, off, m, w, b)]
    y = deform_conv2d(*args, stride=(stride, stride), padding=(pad, pad))
    (y * _nchw(cot)).sum().backward()
    for name, a, g, layout in zip(("x", "offset", "mask", "weight", "bias"), args, want,
                                  ("nchw", "nchw", "nchw", "oihw", None)):
        g = np.asarray(g)
        g = (g.transpose(0, 3, 1, 2) if layout == "nchw" else
             g.transpose(3, 2, 0, 1) if layout == "oihw" else g)
        np.testing.assert_allclose(a.grad.numpy(), g, rtol=2e-4, atol=1e-6 * np.abs(g).max(),
                                   err_msg=name)
        assert np.abs(g).max() > 0, name


@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (1, 1)])
def test_deform_conv_module_matches_jax(k, s):
    """``Conv(c1, c2, k, s, deform=True)`` against JAX's ``Conv(c2, k, s,
    deform=True)`` with every weight drawn (offset and modulator convs
    non-zero), BatchNorm statistics drawn too; the tree loads strict."""
    rng = np.random.default_rng(k * 10 + s)
    x = rng.normal(size=(2, 12, 14, 8)).astype(np.float32)
    jm = JaxConv(6, k, s, deform=True)
    variables = jax_variables(jm, jnp.asarray(x))
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: (np.asarray(v) * (3.0 if "offset_conv" in jax.tree_util.keystr(p) else 1.0)
                      if p[-1].key == "kernel" else
                      rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                      if p[-1].key in ("scale", "var") else
                      rng.normal(0, 0.2, v.shape).astype(np.float32)), variables)
    want = np.asarray(jax.jit(functools.partial(jm.apply, train=False))(
        variables, jnp.asarray(x)))
    pm = Conv(8, 6, k, s, deform=True).eval()
    assert isinstance(pm.conv, DeformableConv2d)
    load_flax_variables(pm, variables)
    with torch.no_grad():
        got = pm(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert float(pm.conv.offset_conv.weight.detach().abs().max()) > 0


def test_deformable_conv_starts_as_the_plain_conv():
    """Zero offsets and a unit modulator at init: the layer is the plain conv
    of ``regular_conv``'s weight, stride 1 and 2."""
    torch.manual_seed(0)
    x = torch.randn(2, 4, 10, 13)
    for s in (1, 2):
        m = DeformableConv2d(4, 7, 3, s, 1)
        torch.nn.init.normal_(m.regular_conv.weight)
        with torch.no_grad():
            torch.testing.assert_close(m(x), m.regular_conv(x), rtol=1e-5, atol=1e-5)
