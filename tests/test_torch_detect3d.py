"""3D serving of the PyTorch port against the JAX package: the YAML parser, the
V10Detect3d head (dense and the sparse top-K patch path), ``decode_detect3d``,
``v10_3d_postprocess`` and ``predict`` end to end, yolov10n_3D at 128x608 on
the CPU.

One module fixture: yolov10n_3D built by the JAX facade with flax's initial
values (``test_torch_predictor.jax_variables``), its variables loaded into
the port (strict), calibrated there on the served images
(``utils/parity.calibrate``: untrained weights otherwise give every score
0.5, and the top-k order is decided by rounding) and copied back into the
JAX tree. At 128x608 the P3 map (16x76) runs sparse and P4 and P5 run
dense, the regimes of tests/test_sparse_infer3d.py.

Bars, and what this CPU run measured:
- JAX's float64 run of the same variables (``jax.enable_x64``) and the
  port's float64 run: 1e-9 + 1e-9 |y|; JAX's float32 maps leave
  1e-4 + 1e-4 |y| of JAX's float64 run at exactly the two P4 values named
  in ``JAX_ROUNDING_OFF`` (3.7e-4 and 1.9e-4 off, where the port is 7.5e-5
  and 9.2e-6 off);
- head maps, port dense vs JAX's float64 run: 1e-4 + 1e-4 |y| at every
  value; port dense vs JAX's float32 maps: 1e-4 + 1e-4 |y| at every value
  but those two (a random net amplifies the two frameworks' rounding layer
  by layer);
- port sparse vs port dense: equal class maps, zero off the candidates,
  1e-4 + 1e-4 |y| at the candidates (measured 1.3e-5) and at every border
  anchor (1.7e-5 on values up to 29; JAX's own test holds the border to
  1e-4 on an uncalibrated net): the sparse path folds BatchNorm to an
  affine, float reassociation only;
- ``decode_detect3d`` against JAX's on the same maps: 1e-5 + 1e-5 |y|
  (measured 0); ``v10_3d_postprocess``: equal;
- ``predict`` vs the JAX facade (spd_serving True on both sides, sparse):
  score 1e-4, 2D box 0.1 px, projected 3D centre 0.1 px, s3d and dep_un 1e-3
  (measured 1.6e-5, 1.7e-3 px, 9.2e-4 px, 2.6e-5 and 6.5e-5, 196 of 200
  detections compared); the port's sparse and dense detections agree within
  the same bars (measured 6.0e-8 and 3.0e-5 px).
"""

import copy
import dataclasses
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from test_torch_predictor import JaxFacade, port_to_flax
from yolov10_3d_tpu.nn.build import build_model as jax_build_model
from yolov10_3d_tpu.nn.build import parse_model_yaml as jax_parse
from yolov10_3d_tpu.ops import pallas_preprocess as JPP
from yolov10_3d_tpu.ops import postprocess as JP
from yolov10_3d_torch import YOLOv10
from yolov10_3d_torch.cfg import resolve_model_cfg
from yolov10_3d_torch.data.preprocess import preprocess_batch
from yolov10_3d_torch.nn.build import parse_model_yaml
from yolov10_3d_torch.nn.heads3d import SPARSE_K, V10Detect3d
from yolov10_3d_torch.ops import postprocess as TP
from yolov10_3d_torch.ops.preprocess import serve_preprocess
from yolov10_3d_torch.utils.parity import calibrate, compare_results, smooth_images
from yolov10_3d_torch.utils.weights import flax_to_torch_state_dict

HW = (128, 608)  # h, w: P3 16x76 sparse, P4 8x38 and P5 4x19 dense
IMGSZ = [HW[1], HW[0]]  # predict's [w, h]
CONF = 0.01
SCORE_TOL, BOX_TOL, REG_TOL = 1e-4, 0.1, 1e-3
COLS = {"center3d": (slice(6, 8), BOX_TOL), "s3d": (slice(8, 11), REG_TOL),
        "dep_un": (slice(15, 16), REG_TOL)}
JAX_CFG = Path(__file__).resolve().parent.parent / "yolov10_3d_tpu/cfg/models/v10-3D"


def _nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous()


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    imgs = smooth_images(rng, [(124, 600)] * 2)  # a small upscale, as KITTI's 375x1242
    jm = JaxFacade("yolov10n_3D.yaml")
    port = YOLOv10("yolov10n_3D.yaml", device="cpu")
    port.model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                                flax_to_torch_state_dict(jm.variables).items()}, strict=True)
    batch, _ = preprocess_batch(imgs, IMGSZ)
    x = _nchw(batch)
    calibrate(port.model, x)
    jm.variables = port_to_flax(jm.variables, port.model)
    dense, _ = jax_build_model(str(JAX_CFG / "yolov10n_3D.yaml"), fast_eval=True)
    jax_maps = jax.jit(lambda v, x: dense.apply(v, x, train=False)["one2one"])(
        jm.variables, jnp.asarray(batch))
    with jax.enable_x64(True):  # JAX's own float64 run of the same variables and input
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jm.variables)
        exact = jax.jit(lambda v, x: dense.apply(v, x, train=False)["one2one"])(
            v64, jnp.asarray(batch, jnp.float64))
        exact = [np.asarray(m) for m in exact]
    assert all(m.dtype == np.float64 for m in exact)
    with torch.no_grad():
        port_dense = port.model(x, fast_eval=True)["one2one"]
        port_sparse = port.model(x, fast_eval=True, sparse=True)["one2one"]
        port_exact = copy.deepcopy(port.model).double()(x.double(), fast_eval=True)["one2one"]
    return dict(jm=jm, port=port, imgs=imgs, x=x, jax_maps=[np.asarray(m) for m in jax_maps],
                dense=port_dense, sparse=port_sparse, exact=exact,
                port_exact=[_nhwc(m) for m in port_exact])


# The values of JAX's float32 head maps that lie outside the bar
# (1e-4 + 1e-4 |y|) of JAX's own float64 run on this input, as
# (level, (image, y, x, channel)): two P4 values of the letterboxed upscale,
# 3.7e-4 and 1.9e-4 off float64, where the port's float32 maps are 7.5e-5
# and 9e-6 off. Everywhere else JAX's float32 maps are the reference.
JAX_ROUNDING_OFF = [(1, (0, 2, 4, 36)), (1, (0, 3, 1, 36))]


def _jax_off(jax_maps, exact):
    """(level, index) of every value where JAX's float32 map is outside the
    bar of JAX's float64 run."""
    return [(lvl, tuple(int(i) for i in idx)) for lvl, (want, e) in enumerate(zip(jax_maps, exact))
            for idx in np.argwhere(np.abs(want - e) > 1e-4 + 1e-4 * np.abs(e))]


def test_jax_float32_maps_off_float64_only_where_named(pair):
    """JAX's float64 run is the port's float64 run (the two frameworks
    compute one function), and JAX's float32 maps leave the bar of it at
    exactly the values named in ``JAX_ROUNDING_OFF``."""
    for mine, theirs in zip(pair["port_exact"], pair["exact"]):
        np.testing.assert_allclose(mine, theirs, rtol=1e-9, atol=1e-9)
    assert _jax_off(pair["jax_maps"], pair["exact"]) == JAX_ROUNDING_OFF


def _jax_held(level, shape):
    held = np.ones(shape, bool)
    for lvl, idx in JAX_ROUNDING_OFF:
        if lvl == level:
            held[idx] = False
    return held


@pytest.mark.parametrize("scale", "nsmblx")
def test_parse_3d_yaml_matches_jax(scale):
    """The port's YAML copies compile to the JAX package's ModelSpec, head
    options included (the port reads the ``channels`` flow mapping itself)."""
    name = f"yolov10{scale}_3D.yaml"
    want = jax_parse(str(JAX_CFG / name))
    got = parse_model_yaml(resolve_model_cfg(name))
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_head_maps_match_jax_dense(pair):
    """The dense head maps within 1e-4 + 1e-4 |y| of JAX's float64 run
    everywhere, and of JAX's float32 maps everywhere but the two values of
    ``JAX_ROUNDING_OFF``."""
    for lvl, (got, want, exact) in enumerate(zip(pair["dense"], pair["jax_maps"], pair["exact"])):
        got = _nhwc(got)
        np.testing.assert_allclose(got, exact, rtol=1e-4, atol=1e-4)
        held = _jax_held(lvl, want.shape)
        np.testing.assert_allclose(got[held], want[held], rtol=1e-4, atol=1e-4)
    assert max(np.abs(w).max() for w in pair["jax_maps"]) > 5  # calibrated, not vanishing


def test_sparse_head_matches_dense(pair):
    """Sparse: the class maps are the dense ones; the regression maps are
    zero off the candidates and the dense values at them (also the border
    candidates); P3 is partly filled, P4 and P5 run dense."""
    nc = pair["port"].spec.nc
    fills = []
    for lvl, (d, s, j) in enumerate(zip(pair["dense"], pair["sparse"], pair["jax_maps"])):
        assert torch.equal(d[:, :nc], s[:, :nc])
        cand = s[:, nc:].abs().sum(1) > 0  # (B, H, W)
        fills.append(float(cand.float().mean()))
        reg_d, reg_s = _nhwc(d)[..., nc:], _nhwc(s)[..., nc:]
        np.testing.assert_allclose(reg_s[cand.numpy()], reg_d[cand.numpy()], rtol=1e-4, atol=1e-4)
        held = _jax_held(lvl, j.shape)[..., nc:] & cand.numpy()[..., None]
        np.testing.assert_allclose(reg_s[held], j[..., nc:][held], rtol=1e-4, atol=1e-4)
        assert (reg_s[~cand.numpy()] == 0).all()
    assert fills[0] == pytest.approx(SPARSE_K / (16 * 76)) and fills[1:] == [1.0, 1.0]


def test_sparse_border_anchors_match_dense(pair):
    """The patch path at every border anchor of the P3 map equals the dense
    map there: the in-map mask zeroes conv1's outputs that fall outside the
    map, as the dense conv2's zero padding does (the case of
    tests/test_sparse_infer3d.py, which needs top-K candidates on the
    border; here the anchors are given). Measured 1.5e-5 on values up to 23."""
    head = pair["port"].model.model[-1]
    nc = pair["port"].spec.nc
    feats = {}
    hook = head.register_forward_pre_hook(lambda m, a: feats.setdefault("xs", a[0]))
    try:
        with torch.no_grad():
            pair["port"].model(pair["x"], fast_eval=True)
    finally:
        hook.remove()
    x = feats["xs"][0]  # P3 input, (2, C, 16, 76)
    B, _, H, W = x.shape
    yy, xx = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    border = ((yy == 0) | (yy == H - 1) | (xx == 0) | (xx == W - 1)).flatten()
    idx = border.nonzero()[:, 0].expand(B, -1)
    with torch.no_grad():
        got = head.patch_regression(x, [h[0] for h in head.o2o_heads()[1:]], idx)
    want = _nhwc(pair["dense"][0]).reshape(B, H * W, -1)[:, border.numpy(), nc:]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_decode_and_postprocess_match_jax(pair):
    spec = pair["port"].spec
    feats = pair["dense"]
    want = JP.decode_detect3d([jnp.asarray(_nhwc(f)) for f in feats], spec.strides, spec.nc)
    got = TP.decode_detect3d(feats, spec.strides, spec.nc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for max_det in (SPARSE_K, 2000):  # 2000 > the 1596 pairs: padded with -1e9
        reg, sc, lab = TP.v10_3d_postprocess(got[:, :532], max_det, spec.nc)
        wreg, wsc, wlab = JP.v10_3d_postprocess(jnp.asarray(got[:, :532].numpy()), max_det,
                                                spec.nc)
        np.testing.assert_array_equal(lab.numpy(), np.asarray(wlab))
        np.testing.assert_array_equal(sc.numpy(), np.asarray(wsc))
        np.testing.assert_array_equal(reg.numpy(), np.asarray(wreg))


def test_predict_matches_jax(pair):
    """``predict`` against the JAX facade, both with spd_serving (the fused
    stem here, the packed stem there) and the sparse head (max_det 50)."""
    jm, port, imgs = pair["jm"], pair["port"], pair["imgs"]
    want = jm.predict(imgs, imgsz=IMGSZ, batch=2, conf=CONF, spd_serving=True)
    got = port.predict(imgs, imgsz=IMGSZ, batch=2, conf=CONF, spd_serving=True)
    assert [r.orig_shape for r in got] == [im.shape[:2] for im in imgs]
    assert got[0].boxes3d.data.shape == (len(got[0]), 16)
    stats = compare_results(want, got, conf=CONF, score_tol=SCORE_TOL, box_tol=BOX_TOL,
                            cols=COLS)
    assert stats["n_compared"] >= 0.5 * (stats["n_ref"] + stats["n_got"]), stats
    s = np.sort(got[0].boxes.conf)
    assert s.max() < 1.0 and np.median(np.diff(s)) > SCORE_TOL  # spread: no ties


def test_predict_sparse_equals_dense_and_stem_routes(pair):
    """In the port: max_det 50 (sparse) and the dense fallback give the same
    top-50; the fused stem and the plain stem give the same detections."""
    port, imgs = pair["port"], pair["imgs"]
    sparse = port.predict(imgs, imgsz=IMGSZ, batch=2, conf=CONF, max_det=SPARSE_K)
    dense = port.predict(imgs, imgsz=IMGSZ, batch=2, conf=CONF, max_det=SPARSE_K + 1)
    for a in (sparse, port.predict(imgs, imgsz=IMGSZ, batch=2, conf=CONF, spd_serving=False)):
        ref = [type(r)(r.orig_img, boxes=r.boxes.data[:SPARSE_K],
                       boxes3d=r.boxes3d.data[:SPARSE_K]) for r in dense]
        stats = compare_results(ref, a, conf=CONF, score_tol=SCORE_TOL, box_tol=BOX_TOL,
                                cols=COLS)
        assert stats["n_compared"] >= 0.5 * (stats["n_ref"] + stats["n_got"]), stats


def test_predict_ignores_int8_with_a_warning(pair):
    with pytest.warns(UserWarning, match="int8=True is ignored"):
        res = pair["port"].predict(pair["imgs"][:1], imgsz=IMGSZ, conf=CONF, int8=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ref = pair["port"].predict(pair["imgs"][:1], imgsz=IMGSZ, conf=CONF)
    np.testing.assert_array_equal(res[0].boxes3d.data, ref[0].boxes3d.data)


def test_kitti_letterbox_on_the_device_matches_jax():
    """A KITTI frame, 375x1242, to 384x1280: a small upscale (gain 1.024)
    with 4-px pads left and right, through the device letterbox, against JAX's. Bar 1e-5 on
    [0, 1] pixels, a four-hundredth of a grey level: the two frameworks round
    the resize weights of this upscale differently (measured 3.5e-6 at 176
    of 1.47 M values; the 128-px downscales of tests/test_torch_preprocess.py
    stay within 1e-6)."""
    img = smooth_images(np.random.default_rng(3), [(375, 1242)])[0]
    got = serve_preprocess(torch.from_numpy(img[None]), (384, 1280))
    want = JPP.serve_preprocess(jnp.asarray(img[None]), (384, 1280))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0, atol=1e-5)
    grey = np.float32(114 / 255)
    x = _nhwc(got)[0]  # 384 x 1272 of image, 4 grey columns on each side
    assert (x[:, :4] == grey).all() and (x[:, -4:] == grey).all()
    assert not (x[:, 4:-4] == grey).all(-1).any()


def test_yolov10m_3d_two_scales_and_1x1_conv2():
    """yolov10m_3D: two scales and kernel_size_2 1 (a 3x3 patch and a 1x1
    conv2, so more scales run sparse): its state_dict matches the JAX tree,
    and sparse equals dense at the candidates and in the detections."""
    jm, _ = jax_build_model(str(JAX_CFG / "yolov10m_3D.yaml"))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 64, 64, 3)), train=False))
    port = YOLOv10("yolov10m_3D.yaml", device="cpu")
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    assert set(flax_to_torch_state_dict(zeros)) == set(port.model.state_dict())
    head = port.model.model[-1]
    assert isinstance(head, V10Detect3d) and (head.nl, head.k1, head.k2) == (2, 3, 1)
    x = torch.rand((1, 3, 128, 256), generator=torch.Generator().manual_seed(0))
    calibrate(port.model, x)
    with torch.no_grad():
        d = port.model(x, fast_eval=True)["one2one"]
        s = port.model(x, fast_eval=True, sparse=True)["one2one"]
    assert len(d) == 2
    nc = port.spec.nc
    for a, b in zip(d, s):  # 16x32 and 8x16 maps, both sparse (2*50*1 < 128)
        cand = b[:, nc:].abs().sum(1) > 0
        assert 0 < float(cand.float().mean()) < 1
        torch.testing.assert_close(b[:, nc:].permute(0, 2, 3, 1)[cand],
                                   a[:, nc:].permute(0, 2, 3, 1)[cand], rtol=1e-4, atol=1e-4)
    preds = [TP.v10_3d_postprocess(TP.decode_detect3d(f, port.spec.strides, nc), SPARSE_K, nc)
             for f in (d, s)]
    assert torch.equal(preds[0][2], preds[1][2]) and torch.equal(preds[0][1], preds[1][1])
    torch.testing.assert_close(preds[0][0], preds[1][0], rtol=1e-4, atol=1e-4)


def test_head_options_build_with_their_routes():
    """Every head option of the v10-3D YAMLs builds (the options no shipped
    YAML sets were refused until the head ported them; each is held to JAX
    in tests/test_torch_head3d_options.py): fgdm_predictor holds the
    DepthPredictor, and only half_channels keeps the sparse route."""
    base = {"channels": {}, "num_scales": 3}
    assert V10Detect3d(3, (64, 128, 256), base).sparse_ok
    assert hasattr(V10Detect3d(3, (64, 128, 256), {**base, "fgdm_predictor": True}),
                   "fgdm_predictor")
    for key in ("dsconv", "deform", "use_predecessors", "common_head", "half_channels"):
        head = V10Detect3d(3, (64, 128, 256), {**base, key: True})
        assert head.sparse_ok == (key == "half_channels"), key
