"""int8 scope ``all`` of the PyTorch port against the JAX package, on the CPU
(the kernels' plain twins; tests/test_torch_kernels.py holds the grouped
kernel to its twin on the card).

The gate, then yolov10n at 64x64 (the grouped conv alone is
tests/test_torch_int8_group.py's), its variables
from ``test_torch_predictor.jax_variables`` loaded into the port, calibrated
there for int8 (``utils/parity.calibrate(..., int8=...)``) and copied back,
against JAX's int8 forward at scope ``all`` (one traced apply with the
``_Int8Conv`` calls captured, one2many branches included) and JAX's float32
forward.

Bars, and what this CPU run measured:
- JAX's gate order: deformable and space-to-depth convs stay float;
- the gated convs, by module path, are JAX's ``_Int8Conv`` calls;
- the one2one head maps of the whole int8 forward differ from JAX's int8
  ones by at most a tenth of JAX's own int8-versus-float32 gap (the bar of
  tests/test_torch_int8.py; measured 4.8e-6 of 7.1);
- the detections of those maps, decoded alike: score 1e-3 and box 0.1 px,
  tests/test_torch_int8.py's bars (measured 3.6e-7 and 3.1e-5 px, 394 of
  400 detections compared).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from test_torch_int8 import _int8_paths, _nchw
from test_torch_predictor import JaxFacade, port_to_flax
from yolov10_3d_tpu.nn import modules as JM
from yolov10_3d_torch import YOLOv10
from yolov10_3d_torch.data.preprocess import preprocess_batch
from yolov10_3d_torch.kernels import launch_counts
from yolov10_3d_torch.nn import modules as M
from yolov10_3d_torch.nn.quant import STATIC_ACT_SCALE, Int8Config, gated, plan_int8
from yolov10_3d_torch.ops.postprocess import v10_detections
from yolov10_3d_torch.utils.parity import calibrate, match_detections, smooth_images
from yolov10_3d_torch.utils.weights import load_flax_variables

IMGSZ = 64
CONF = 0.01
SCORE_TOL, BOX_TOL = 1e-3, 0.1  # tests/test_torch_int8.py's int8 bars
ALL = Int8Config(scope="all")


@contextlib.contextmanager
def jax_int8_mode(scope, act_scale=STATIC_ACT_SCALE):
    """JAX's int8 mode for the traces inside, switched off in a finally."""
    JM.set_int8_mode(True, act_scale=act_scale, scope=scope)
    try:
        yield
    finally:
        JM.set_int8_mode(False)


def test_gate_follows_jax_order():
    """JAX's elif order: a deformable conv and a space-to-depth conv are never
    gated, at any scope; every other Conv is under 'all'."""
    deform = M.Conv(8, 8, 3, deform=True)
    spd = M.Conv(8, 8, 3, 2, spd=True)
    dense1x1 = M.Conv(8, 8, 1)
    for scope in ("k3", "k3deep", "all"):
        cfg = Int8Config(scope=scope)
        assert not gated(deform, 64, cfg) and not gated(spd, 64, cfg)
    assert gated(dense1x1, 10**6, ALL) and not gated(dense1x1, 10**6, Int8Config())


# --------------------------------------------------------- model fixture
@pytest.fixture(scope="module")
def pair():
    imgs = smooth_images(np.random.default_rng(0), [(IMGSZ, IMGSZ)] * 2)
    batch, _ = preprocess_batch(imgs, IMGSZ)
    jm = JaxFacade("yolov10n.yaml")
    port = YOLOv10("yolov10n.yaml", device="cpu")
    load_flax_variables(port.model, jm.variables)
    calibrate(port.model, _nchw(batch), int8=ALL)
    jm.variables = port_to_flax(jm.variables, port.model)

    def apply(v, x):  # the facade's model runs its one2many branches too
        out, state = jm.model.apply(v, x, train=False, mutable=["intermediates"],
                                    capture_intermediates=lambda m, _: isinstance(m, JM._Int8Conv))
        return out["one2one"], state["intermediates"]

    with jax_int8_mode("all"):
        feats8, inter = jax.jit(apply)(jm.variables, jnp.asarray(batch))
    feats32 = jax.jit(lambda v, x: jm.model.apply(v, x, train=False)["one2one"])(
        jm.variables, jnp.asarray(batch))
    before = dict(launch_counts)
    with torch.no_grad():
        got = port.model(_nchw(batch), fast_eval=True, int8=ALL)["one2one"]
    return dict(port=port, batch=batch, inter=inter, got=got, launched=launch_counts != before,
                feats8=[np.asarray(f) for f in feats8],
                feats32=[np.asarray(f) for f in feats32],
                plan=plan_int8(port.model, (IMGSZ, IMGSZ), ALL, one2many=True))


def test_gated_convs_match_jax_all(pair):
    """The plan's convs, by module path, are JAX's _Int8Conv calls at scope
    'all' (one2many included): every Conv of yolov10n, and the grouped ones
    (SCDown.cv2, CIB's depthwise convs, Attention.pe, the class branches'
    depthwise convs) on the new route."""
    plan = pair["plan"]
    convs = [m for m in pair["port"].model.modules() if isinstance(m, M.Conv)]
    assert set(plan.paths()) == _int8_paths(pair["inter"])
    assert len(plan.routes) == len(convs)
    grouped = {n for n, r in plan.paths().items() if r == "int8_group_conv_f32"}
    assert grouped == {n for n, m in pair["port"].model.named_modules()
                       if isinstance(m, M.Conv) and m.conv.groups > 1}
    assert plan.counts()["int8_group_conv_f32"] == 20 and "model.5.cv2" in grouped


def test_whole_model_all_matches_jax(pair):
    """The one2one maps of the port's scope-'all' forward against JAX's, within
    a tenth of JAX's own int8-versus-float32 gap; the CPU launches nothing."""
    assert not pair["launched"]
    err = max(np.abs(g.permute(0, 2, 3, 1).numpy() - w).max()
              for g, w in zip(pair["got"], pair["feats8"]))
    effect = max(np.abs(a - b).max() for a, b in zip(pair["feats8"], pair["feats32"]))
    assert effect > 0.05 and err <= 0.1 * effect, (err, effect)


def _rows(feats, strides, nc):
    """[x1, y1, x2, y2, score, class] rows per image above CONF."""
    det = v10_detections(feats, strides, nc, max_det=100)
    rows = torch.cat([det["boxes"], det["scores"][..., None], det["labels"][..., None].float()],
                     -1).numpy().astype(np.float64)
    return [r[r[:, 4] > CONF] for r in rows]


def test_detections_all_match_jax(pair):
    """The detections of the port's and JAX's scope-'all' maps, decoded alike
    (``ops/postprocess.py`` ``v10_detections``): score 1e-3, box 0.1 px."""
    spec = pair["port"].spec
    want = _rows([_nchw(f) for f in pair["feats8"]], spec.strides, spec.nc)
    got = _rows(pair["got"], spec.strides, spec.nc)
    stats = [match_detections(a, b, CONF, SCORE_TOL, BOX_TOL) for a, b in zip(want, got)]
    n = sum(s["n_compared"] for s in stats)
    assert n >= 0.5 * sum(s["n_ref"] + s["n_got"] for s in stats), stats


def test_all_differs_from_k3deep(pair):
    """Scope 'all' computes another function than k3deep (the depthwise and
    high-resolution 1x1 convs quantize too), and both plans keep their fused
    sites."""
    with torch.no_grad():
        b = pair["port"].model(_nchw(pair["batch"]), fast_eval=True, int8=Int8Config())["one2one"]
    assert any(not torch.equal(u, v) for u, v in zip(pair["got"], b))
    for cfg in (ALL, Int8Config()):
        counts = plan_int8(pair["port"].model, (IMGSZ, IMGSZ), cfg).counts()
        assert counts["int8_mm_fused"] == 2 and counts["int8_conv3x3_fused"] > 0
