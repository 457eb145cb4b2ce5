"""``spd_stem`` of the PyTorch port (``ops/spd_stem.py``, ``Conv(spd=True)``,
``build_model(..., spd_stem=...)``) against the JAX package's space-to-depth
rewrite (``yolov10_3d_tpu/ops/spd_stem.py``, ``build_model(spd_stem=...)``),
on the CPU.

Bars, those of the JAX package's own tests/test_spd_stem.py, and what this
CPU run measured:
- ``space_to_depth`` and ``repack_stem_kernel`` move the same values to the
  same places: equal;
- the rewritten conv against JAX's ``spd_stem_conv`` and against the plain
  3x3 stride-2 conv: rtol 1e-5, atol 1e-5 (measured 5.7e-6 both);
- yolov10n with ``spd_stem="all"`` at flax's initial values (BatchNorm at
  identity, as JAX's test runs): the variables of JAX's rewritten model
  load ``strict=True``, the same layers are rewritten (JAX's
  ``_SPDStemConv`` calls), and the head maps meet JAX's rewritten model's,
  and the port's plain model's, at rtol 1e-4, atol 1e-4. At these values
  the maps are small (max |y| 3.7e-4), so they are also held within 1e-4
  of their largest value (measured 4.9e-10 from JAX's, 3.4e-10 from the
  plain model's: 1.3e-6 of it). On a net calibrated to BatchNorm std 0.5
  both gaps grow to 6e-3 of values up to 11, the float32 rounding of a
  random net amplified layer by layer, as tests/test_torch_detect3d.py
  describes;
- the rewritten convs stay float under int8 at every scope (JAX's gate
  takes its ``spd`` branch first): the plan's convs are JAX's
  ``_Int8Conv`` calls;
- the Predictor with ``spd_serving=False`` serves the model's own layers
  (its space-to-depth convs), with True the fused stem kernel's layer 0 and
  the rewritten convs after it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from test_torch_int8 import _int8_paths, _nchw
from test_torch_int8_all import jax_int8_mode
from test_torch_predictor import jax_variables
from yolov10_3d_tpu.nn import modules as JM
from yolov10_3d_tpu.nn.build import build_model as jax_build_model
from yolov10_3d_tpu.ops import spd_stem as JS
from yolov10_3d_torch.engine.predictor import Predictor
from yolov10_3d_torch.nn import modules as M
from yolov10_3d_torch.nn.build import build_model
from yolov10_3d_torch.nn.quant import Int8Config, plan_int8
from yolov10_3d_torch.ops import spd_stem as PS
from yolov10_3d_torch.ops.postprocess import v10_detections
from yolov10_3d_torch.utils.parity import smooth_images
from yolov10_3d_torch.utils.weights import load_flax_variables

JAX_YAML = "yolov10_3d_tpu/cfg/models/v10/yolov10n.yaml"
PORT_YAML = "yolov10_3d_torch/cfg/models/v10/yolov10n.yaml"
IMGSZ = 64


def test_space_to_depth_and_repack_match_jax():
    """The packing of the input and of the weight, value for value."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 12, 5)).astype(np.float32)
    k = rng.normal(size=(3, 3, 5, 7)).astype(np.float32)
    want = np.asarray(JS.space_to_depth(jnp.asarray(x)))
    got = PS.space_to_depth(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(JS.repack_stem_kernel(jnp.asarray(k)))  # (2, 2, 4C, O)
    got = PS.repack_stem_kernel(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()))
    np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(), want)


def test_spd_conv_matches_jax():
    """The rewritten conv against JAX's and against the plain stride-2 conv,
    at the shapes of JAX's test."""
    rng = np.random.default_rng(3)
    for H, W, C, O in [(64, 96, 3, 16), (32, 32, 5, 8)]:
        x = rng.normal(size=(2, H, W, C)).astype(np.float32)
        k = rng.normal(size=(3, 3, C, O)).astype(np.float32)
        want = np.asarray(JS.spd_stem_conv(jnp.asarray(x), jnp.asarray(k)))
        w = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
        got = PS.spd_conv(_nchw(x), w)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(got, F.conv2d(_nchw(x), w, stride=2, padding=1),
                                   rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    imgs = smooth_images(np.random.default_rng(0), [(IMGSZ, IMGSZ)] * 2)
    x = torch.from_numpy(np.stack(imgs)).permute(0, 3, 1, 2).float().div(255).contiguous()
    jm, _ = jax_build_model(JAX_YAML, spd_stem="all")
    variables = jax_variables(jm, jnp.zeros((1, IMGSZ, IMGSZ, 3), jnp.float32))
    model, spec = build_model(PORT_YAML, device="cpu", spd_stem="all")
    load_flax_variables(model, variables)
    plain, _ = build_model(PORT_YAML, device="cpu")
    plain.load_state_dict(model.state_dict())
    return dict(jm=jm, variables=variables, model=model, plain=plain, spec=spec, x=x)


def test_spd_all_model_matches_jax(pair):
    """yolov10n with spd_stem='all': JAX's tree loads strict (above), the
    rewritten layers are JAX's (every dense k3/s2 Conv layer: 0, 1, 3 and
    the neck's 17), and the head maps meet JAX's rewritten model's."""
    model, x = pair["model"], pair["x"]

    def apply(v, x):
        out, state = pair["jm"].apply(
            v, x, train=False, mutable=["intermediates"],
            capture_intermediates=lambda m, _: isinstance(m, JM._SPDStemConv))
        return out, state["intermediates"]

    want, inter = jax.jit(apply)(pair["variables"], jnp.asarray(x.permute(0, 2, 3, 1).numpy()))
    rewritten = {n for n, m in model.named_modules() if isinstance(m, M.Conv) and m.spd}
    assert rewritten == _int8_paths(inter) == {"model.0", "model.1", "model.3", "model.17"}
    with torch.no_grad():
        got = model(x)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want["one2one"])
    for key in ("one2one", "one2many"):
        for g, w in zip(got[key], want[key]):
            g, w = g.permute(0, 2, 3, 1).numpy(), np.asarray(w)
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
            assert np.abs(g - w).max() <= 1e-4 * scale
    with torch.no_grad():
        ref = pair["plain"](x)["one2one"]
    for g, r in zip(got["one2one"], ref):  # the rewrite computes the plain model's function
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)
        assert float((g - r).abs().max()) <= 1e-4 * scale


def test_spd_convs_stay_float_under_int8(pair):
    """The rewritten convs are outside the int8 gate at scope all (and k3),
    as JAX's are: the plan's convs are the JAX forward's _Int8Conv calls."""
    model, x = pair["model"], pair["x"]

    def apply(v, x):
        _, state = pair["jm"].apply(v, x, train=False, mutable=["intermediates"],
                                    capture_intermediates=lambda m, _: isinstance(m, JM._Int8Conv))
        return state["intermediates"]

    with jax_int8_mode("all"):
        inter = jax.jit(apply)(pair["variables"], jnp.asarray(x.permute(0, 2, 3, 1).numpy()))
    plan = plan_int8(model, (IMGSZ, IMGSZ), Int8Config(scope="all"), one2many=True)
    assert set(plan.paths()) == _int8_paths(inter)
    assert not {"model.0", "model.1", "model.3", "model.17"} & set(plan.paths())
    k3 = plan_int8(model, (IMGSZ, IMGSZ), Int8Config(scope="k3"), one2many=True)
    assert "model.1" not in k3.paths() and "model.1" in plan_int8(
        pair["plain"], (IMGSZ, IMGSZ), Int8Config(scope="k3"), one2many=True).paths()


def test_predictor_serves_the_models_spd_stem(pair):
    """spd_serving=False serves the model's own layers, the rewritten convs
    included; True serves layer 0 as the fused stem kernel (its twin here)
    and keeps the rewrite after it; any other value is refused."""
    model, spec, x = pair["model"], pair["spec"], pair["x"]
    for spd in (False, True):
        pred = Predictor(model, spec, {"spd_serving": spd})
        got = pred.forward_eager(x, 100)
        with torch.no_grad():
            feats = model(x, fast_eval=True, stem=spd)["one2one"]
            det = v10_detections(feats, spec.strides, spec.nc, max_det=100)
        torch.testing.assert_close(got[..., :5], torch.cat(
            [det["boxes"], det["scores"][..., None]], -1), rtol=0, atol=0)
    with pytest.raises(ValueError, match="spd_serving"):
        Predictor(model, spec, {"spd_serving": "all"})
