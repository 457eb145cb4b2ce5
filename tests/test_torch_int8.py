"""int8 serving of the PyTorch port against the JAX package's int8 mode, on
the CPU (the kernels' plain twins; tests/test_torch_kernels.py holds the
CUDA kernels to the twins on the card).

One module fixture: yolov10n initialised by JAX in int8 mode, its variables
loaded into the port, calibrated there on the served images
(``utils/parity.calibrate``, head scales fitted to the int8 outputs) and
copied back, so that activations spread over the int8 range and the int8
scores do not saturate. JAX runs its int8 forward once under
``set_int8_mode(True, 8/127, "k3deep")`` (the JAX Predictor's setting), with
every ``Conv``'s input and output intercepted and the ``_Int8Conv`` calls
captured, and once in float32.

Bars, and what this CPU run measured:
- the kernels' twins equal the Pallas kernels (interpret mode) bit for bit;
- the port's quantization equals ``int8_conv``'s, bit for bit;
- every float-epilogue conv, given JAX's float input, meets JAX's output at
  rtol 1e-5 and atol 1e-5 (measured: at most 7.6e-6 absolute; the gap is
  the last bit of rsqrt, exp and the float32 sums);
- every fused site's int8 codes equal JAX's quantization of the consumer's
  input except at most a fraction 1e-4 of them (at least one), off by
  exactly 1 (measured: none of 54272 codes differ);
- the one2one head maps of the whole int8 forward differ from JAX's int8
  ones by at most a tenth of JAX's own int8-versus-float32 gap (measured:
  1.05e-5 against 7.75);
- ``predict(int8=True)`` meets the JAX facade's at score 1e-3 and box
  0.1 px (measured: 3.6e-7 and 2.3e-5 px, 190 of 200 detections compared),
  with spd_serving False on both sides and True on both sides (the stem
  then stays float on both: the JAX space-to-depth stem is outside its
  int8 gate, and the port's fused stem outside its int8 plan).
"""

import importlib.util
from collections.abc import Mapping
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from test_torch_predictor import JaxFacade, port_to_flax
from yolov10_3d_tpu.nn import modules as JM
from yolov10_3d_tpu.ops.pallas_kernels import int8_conv3x3_fused as pallas_k3
from yolov10_3d_tpu.ops.pallas_kernels import int8_mm_fused as pallas_k2
from yolov10_3d_torch import YOLOv10
from yolov10_3d_torch.data.preprocess import preprocess_batch
from yolov10_3d_torch.kernels import int8 as K8
from yolov10_3d_torch.kernels import launch_counts
from yolov10_3d_torch.nn import modules as M
from yolov10_3d_torch.nn.quant import (
    STATIC_ACT_SCALE, Int8Config, Int8Plan, plan_int8, quantize_act, quantize_weight,
)
from yolov10_3d_torch.utils.parity import calibrate, compare_results, smooth_images
from yolov10_3d_torch.utils.weights import _dotted, load_flax_variables

IMGSZ = 64
CONF = 0.01
SCORE_TOL, BOX_TOL = 1e-3, 0.1
FUSED = ("int8_mm_fused", "int8_conv3x3_fused")


def _nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous()


# ------------------------------------------------- kernels' twins vs Pallas
def _k_inputs(seed, xs, ws, lo=-127, hi=128):
    rng = np.random.default_rng(seed)
    xq = rng.integers(lo, hi, xs).astype(np.int8)
    wq = rng.integers(lo, hi, ws).astype(np.int8)
    n = ws[-1]
    scale = rng.uniform(1e-4, 2e-4, n).astype(np.float32)
    bias = rng.uniform(-0.1, 0.1, n).astype(np.float32)
    ep = K8.affine_epilogue(torch.from_numpy(scale), torch.from_numpy(bias))
    return xq, wq, scale, bias, ep


@pytest.mark.parametrize("M,K,N,bm,bn", [(64, 32, 48, 32, 16), (96, 64, 40, 32, 16),
                                         (80, 32, 128, 16, 64)])
def test_k2_twin_matches_pallas(M, K, N, bm, bn):
    """K2's twin against ``int8_mm_fused`` in interpret mode, bit for bit, at
    the shape of tests/test_pallas_kernels.py, at an N that is not a
    multiple of the requested block, and in PSA ffn.0's orientation (K < N,
    256 -> 512 in YOLOv10-S)."""
    xq, wq, scale, bias, ep = _k_inputs(1, (M, K), (K, N))
    want = np.asarray(pallas_k2(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(scale),
                                jnp.asarray(bias), jnp.asarray(np.float32(17.0)),
                                block_m=bm, block_n=bn, interpret=True))
    got = K8.int8_mm_fused(torch.from_numpy(xq), torch.from_numpy(wq.T.copy()), ep, 17.0)
    np.testing.assert_array_equal(got.numpy(), want)


def _tool(name: str):
    """A script of tools/ (a folder of scripts, not a package), by path."""
    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parents[1] / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("B,H,W,K,N", [(2, 5, 7, 64, 48), (1, 4, 4, 32, 96)])
def test_k2_twin_matches_t3_reference(B, H, W, K, N):
    """K2's twin against T3's plain XLA reference (``tools/int8_experiments.py``
    ``conv_int8_flow``: the 1x1 int8 conv, int32 sums, the epilogue left to
    XLA's fusion; T3 ``pallas_int8_mm`` computes it in one kernel), jitted
    on the CPU, at 1x1 shapes with K > N and K < N: bit for bit."""
    flow = jax.jit(_tool("int8_experiments").conv_int8_flow)
    xq, wq, scale, bias, ep = _k_inputs(3, (B, H, W, K), (1, 1, K, N))
    want = np.asarray(flow(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(scale),
                           jnp.asarray(bias), np.float32(17.0)))
    got = K8.int8_mm_fused(torch.from_numpy(xq.reshape(-1, K)),
                           torch.from_numpy(wq.reshape(K, N).T.copy()), ep, 17.0)
    np.testing.assert_array_equal(got.numpy(), want.reshape(-1, N))


@pytest.mark.parametrize("B,H,W,K,N,bn", [(2, 8, 10, 16, 24, 8), (1, 5, 7, 8, 20, 8)])
def test_k3_twin_matches_pallas(B, H, W, K, N, bn):
    """K3's twin against ``int8_conv3x3_fused`` in interpret mode, bit for
    bit, at the shape of tests/test_pallas_kernels.py and a ragged one."""
    xq, wq, scale, bias, ep = _k_inputs(2, (B, H, W, K), (3, 3, K, N), -80, 81)
    want = np.asarray(pallas_k3(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(scale),
                                jnp.asarray(bias), jnp.asarray(np.float32(11.0)),
                                block_n=bn, interpret=True))
    got = K8.int8_conv3x3_fused(torch.from_numpy(xq),
                                torch.from_numpy(wq.transpose(3, 0, 1, 2).copy()), ep, 11.0)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------ quantization vs int8_conv
@pytest.mark.parametrize("act_scale", [STATIC_ACT_SCALE, None], ids=["static", "dynamic"])
def test_quantize_act_matches_int8_conv(act_scale):
    """The codes and scale ``int8_conv`` uses, read back through the jitted
    function itself: with identity 1x1 weights every code is 127 * xq, and
    its output is that integer times float32(sx * sw)."""
    rng = np.random.default_rng(3)
    x = (rng.normal(0, 2.5, (2, 6, 7, 16)) * rng.uniform(0.2, 1, 16)).astype(np.float32)
    eye = np.eye(16, dtype=np.float32)[None, None]
    f = jax.jit(lambda x: JM.int8_conv(x, jnp.asarray(eye), (1, 1), ((0, 0), (0, 0)),
                                       act_scale=act_scale))
    y = np.asarray(f(jnp.asarray(x)))
    xq, sx = quantize_act(_nchw(x), act_scale)
    _, sw = quantize_weight(torch.from_numpy(eye.transpose(3, 2, 0, 1).copy()))
    codes = xq.permute(0, 2, 3, 1).numpy().astype(np.float32) * 127
    np.testing.assert_array_equal(codes * (sx * sw).numpy(), y)


def test_quantize_weight_matches_int8_conv():
    """One-hot images at act_scale 1 read every weight of a 3x3 kernel back
    as float32(wq * sw), with no padding."""
    rng = np.random.default_rng(4)
    K, N = 8, 12
    w = (rng.normal(0, 0.3, (3, 3, K, N)) * rng.uniform(0.1, 1, N)).astype(np.float32)
    onehot = np.eye(9 * K, dtype=np.float32).reshape(9 * K, 3, 3, K)
    f = jax.jit(lambda x: JM.int8_conv(x, jnp.asarray(w), (1, 1), ((0, 0), (0, 0)),
                                       act_scale=1.0))
    y = np.asarray(f(jnp.asarray(onehot))).reshape(3, 3, K, N)
    wq, sw = quantize_weight(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
    got = (wq.float() * sw[:, None, None, None]).permute(2, 3, 1, 0).numpy()
    np.testing.assert_array_equal(got, y)


@pytest.mark.parametrize("k,s", [(3, 2), (1, 1)])
def test_dynamic_scale_conv_matches_jax(k, s):
    """A gated Conv with the dynamic max-abs activation scale (the float
    epilogue route, whose dequant scale is computed per call) against the
    JAX Conv traced under set_int8_mode(True, act_scale=None)."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1.5, (2, 6, 6, 16)).astype(np.float32)
    jconv = JM.Conv(24, k, s)
    v = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree.map(lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape).astype(np.float32)
                     if a.ndim == 1 else a, v)  # BN away from identity
    JM.set_int8_mode(True, act_scale=None, scope="k3deep")
    try:
        want = np.asarray(jax.jit(lambda v, x: jconv.apply(v, x))(v, jnp.asarray(x)))
    finally:
        JM.set_int8_mode(False)
    conv = load_flax_variables(M.Conv(16, 24, k, s), v)
    cfg = Int8Config(act_scale=None)
    plan = Int8Plan(cfg, {conv: 36}, {conv: "int8_conv_f32"}, {conv: "conv"})
    with torch.no_grad():
        got = conv(_nchw(x), plan).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_int8_config_scopes():
    """k3, k3deep and 'all' (grouped and depthwise convs too) are ported:
    'all' builds and plans every Conv, its grouped convs on the
    int8_group_conv_f32 route; a dynamic scale runs every gated conv with a
    float epilogue."""
    with pytest.raises(ValueError, match="scope"):
        Int8Config(scope="bogus")
    model = YOLOv10("yolov10n.yaml", device="cpu").model
    k3 = plan_int8(model, (64, 64), Int8Config(scope="k3")).counts()
    deep = plan_int8(model, (64, 64), Int8Config()).counts()
    dyn = plan_int8(model, (64, 64), Int8Config(act_scale=None)).counts()
    every = plan_int8(model, (64, 64), Int8Config(scope="all")).counts()
    assert sum(k3.values()) < sum(deep.values()) == sum(dyn.values()) < sum(every.values())
    assert every["int8_group_conv_f32"] > 0 and deep["int8_group_conv_f32"] == 0
    assert dyn["int8_mm_fused"] == dyn["int8_conv3x3_fused"] == 0
    assert all(deep[r] > 0 for r in FUSED)


def test_plan_of_yolov10s_at_640():
    """The routes at the served size: 44 gated convs, two K2 sites (SPPF.cv1,
    PSA ffn.0) and eleven K3 sites (eight Bottleneck.cv1, three head box
    convs); the plan follows the input size through the k3deep gate."""
    model = YOLOv10("yolov10s.yaml", device="cpu").model
    plan = plan_int8(model, (640, 640), Int8Config())
    assert plan.counts() == {"int8_mm_fused": 2, "int8_conv3x3_fused": 11, "int8_conv_f32": 31,
                             "int8_group_conv_f32": 0}
    paths = plan.paths()
    assert paths["model.9.cv1"] == paths["model.10.ffn.0"] == "int8_mm_fused"
    assert paths["model.23.one2one_cv2.0.0"] == "int8_conv3x3_fused"
    assert "model.23.one2one_cv3.0.0.1" not in paths  # 1x1 at 80x80: float
    small = plan_int8(model, (320, 320), Int8Config()).counts()
    assert sum(small.values()) > 44


def test_plan_with_the_fused_stem():
    """spd_serving: the stem runs the fused stem kernel and leaves the int8
    plan, 43 gated convs (2 / 11 / 30) for YOLOv10-S at 640, as JAX's
    space-to-depth stem leaves its int8 gate."""
    model = YOLOv10("yolov10s.yaml", device="cpu").model
    plan = plan_int8(model, (640, 640), Int8Config(), stem=True)
    assert plan.counts() == {"int8_mm_fused": 2, "int8_conv3x3_fused": 11, "int8_conv_f32": 30,
                             "int8_group_conv_f32": 0}
    assert set(plan_int8(model, (640, 640), Int8Config()).paths()) - set(plan.paths()) == {
        "model.0"}


# --------------------------------------------------------- model fixture
@pytest.fixture(scope="module")
def pair():
    imgs = smooth_images(np.random.default_rng(0), [(IMGSZ, IMGSZ)] * 2)
    batch, _ = preprocess_batch(imgs, IMGSZ)  # (2, 64, 64, 3) float32
    jm = JaxFacade("yolov10n.yaml")  # its values are replaced by the port's below
    JM.set_int8_mode(True, scope="k3deep")
    try:  # the variables of the model traced in int8 mode
        v8 = jax.jit(jm.model.init, static_argnames="train")(
            jax.random.PRNGKey(0), jnp.asarray(batch), train=False)
    finally:
        JM.set_int8_mode(False)
    port = YOLOv10("yolov10n.yaml", device="cpu")
    load_flax_variables(port.model, v8)
    calibrate(port.model, _nchw(batch), int8=Int8Config())
    jm.variables = port_to_flax(jm.variables, port.model)

    def capture(v, x):
        rec = {}

        def icpt(next_fun, args, kwargs, ctx):
            out = next_fun(*args, **kwargs)
            if isinstance(ctx.module, JM.Conv) and ctx.method_name == "__call__":
                rec[_dotted(ctx.module.path)] = (args[0], out)
            return out

        with fnn.intercept_methods(icpt):
            out, state = jm.model.apply(
                v, x, train=False, mutable=["intermediates"],
                capture_intermediates=lambda m, _: isinstance(m, JM._Int8Conv))
        return out["one2one"], rec, state["intermediates"]

    JM.set_int8_mode(True, scope="k3deep")
    try:
        feats8, convs, inter = jax.jit(capture)(jm.variables, jnp.asarray(batch))
    finally:
        JM.set_int8_mode(False)
    feats32 = jax.jit(lambda v, x: jm.model.apply(v, x, train=False)["one2one"])(
        jm.variables, jnp.asarray(batch))
    plan = plan_int8(port.model, (IMGSZ, IMGSZ), Int8Config(), one2many=True)
    return dict(jm=jm, port=port, v8=v8, batch=batch, imgs=imgs, plan=plan,
                feats8=[np.asarray(f) for f in feats8],
                feats32=[np.asarray(f) for f in feats32],
                convs={k: (np.asarray(a), np.asarray(b)) for k, (a, b) in convs.items()},
                inter=inter)


def _int8_paths(tree, prefix=()):
    """Module paths of the Conv modules whose _Int8Conv was captured."""
    out = set()
    for k, v in tree.items():
        if k == "__call__":
            out.add(_dotted(prefix[:-1]))  # drop the 'conv' child
        elif isinstance(v, Mapping):
            out |= _int8_paths(v, prefix + (k,))
    return out


def test_jax_int8_variables_load_strict(pair):
    """_Int8Conv declares nn.Conv's kernel: the JAX model initialised in int8
    mode loads into the port with strict=True, as the float one does."""
    fresh = YOLOv10("yolov10n.yaml", device="cpu")
    load_flax_variables(fresh.model, pair["v8"])
    assert jax.tree.structure(pair["v8"]) == jax.tree.structure(pair["jm"].variables)


def test_gated_convs_match_jax(pair):
    """The port's gated convs, by module path, are the JAX forward's
    _Int8Conv calls (one2many branches included), and the plan fuses some."""
    paths = pair["plan"].paths()
    assert set(paths) == _int8_paths(pair["inter"])
    assert {r for r in paths.values()} == {"int8_mm_fused", "int8_conv3x3_fused",
                                           "int8_conv_f32"}


def _port_conv(pair, path):
    return pair["port"].model.get_submodule(path)


def test_float_epilogue_convs_match_jax(pair):
    """Each int8_conv_f32 conv, given JAX's float input, meets JAX's Conv."""
    plan, n = pair["plan"], 0
    for path, route in plan.paths().items():
        if route != "int8_conv_f32":
            continue
        x, want = pair["convs"][path]
        with torch.no_grad():
            got = plan.run(_port_conv(pair, path), _nchw(x), route)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5,
                                   atol=1e-5, err_msg=path)
        n += 1
    assert n >= 40


def test_fused_sites_match_jax_quantization(pair):
    """Each K2/K3 site's codes, given JAX's float input, equal JAX's
    quantization of the producer output that its consumer reads (through
    the SPPF pools, which commute with it): all but a fraction 1e-4 (at
    least one code), and those off by exactly 1."""
    plan, n = pair["plan"], 0
    inv = np.float32(1) / np.float32(STATIC_ACT_SCALE)  # XLA's x / const
    for path, route in plan.paths().items():
        if route not in FUSED:
            continue
        x, y = pair["convs"][path]
        want = np.clip(np.round(y * inv), -127, 127).astype(np.int8)
        with torch.no_grad():
            got = plan.run(_port_conv(pair, path), _nchw(x), route).numpy()
        diff = np.abs(got.astype(np.int32) - want)
        assert diff.max() <= 1, path
        assert (diff > 0).sum() <= max(1, 1e-4 * diff.size), (path, (diff > 0).sum())
        n += 1
    assert n == sum(plan.counts()[r] for r in FUSED) >= 4


def test_whole_model_int8_matches_jax(pair):
    """One2one head maps of the port's int8 forward against JAX's int8
    forward, within a tenth of JAX's own int8 quantization effect. The CPU
    forward runs the twins only: no kernel launch is counted."""
    before = dict(launch_counts)
    with torch.no_grad():
        got = pair["port"].model(_nchw(pair["batch"]), fast_eval=True,
                                 int8=Int8Config())["one2one"]
    assert launch_counts == before
    err = max(np.abs(g.permute(0, 2, 3, 1).numpy() - w).max()
              for g, w in zip(got, pair["feats8"]))
    effect = max(np.abs(a - b).max() for a, b in zip(pair["feats8"], pair["feats32"]))
    assert effect > 0.05 and err <= 0.1 * effect, (err, effect)


def test_predict_int8_matches_jax(pair):
    """``predict(int8=True)`` against the JAX facade's int8 serving
    (``spd_serving=False``) on the same calibrated weights and images."""
    jm, port, imgs = pair["jm"], pair["port"], pair["imgs"]
    want = jm.predict(imgs, imgsz=IMGSZ, batch=2, conf=CONF, int8=True, spd_serving=False)
    got = port.predict(imgs, imgsz=IMGSZ, batch=2, conf=CONF, int8=True, spd_serving=False)
    stats = compare_results(want, got, conf=CONF, score_tol=SCORE_TOL, box_tol=BOX_TOL)
    assert stats["n_compared"] >= 0.5 * (stats["n_ref"] + stats["n_got"]), stats
    fp32 = port.predict(imgs, imgsz=IMGSZ, batch=2, conf=CONF, spd_serving=False)
    assert any(not np.array_equal(a.boxes.data, b.boxes.data) for a, b in zip(got, fp32))


def test_predict_int8_spd_serving_matches_jax(pair):
    """int8 with the default spd_serving on both sides: the stem is a float
    fused stem in the port and JAX's float packed stem; the other gated
    convs are int8 on both."""
    jm, port, imgs = pair["jm"], pair["port"], pair["imgs"]
    want = jm.predict(imgs, imgsz=IMGSZ, batch=2, conf=CONF, int8=True, spd_serving=True)
    got = port.predict(imgs, imgsz=IMGSZ, batch=2, conf=CONF, int8=True, spd_serving=True)
    stats = compare_results(want, got, conf=CONF, score_tol=SCORE_TOL, box_tol=BOX_TOL)
    assert stats["n_compared"] >= 0.5 * (stats["n_ref"] + stats["n_got"]), stats
    plain = port.predict(imgs, imgsz=IMGSZ, batch=2, conf=CONF, int8=True, spd_serving=False)
    assert any(not np.array_equal(a.boxes.data, b.boxes.data) for a, b in zip(got, plain))


def test_int8_weights_follow_load_state_dict(pair):
    """The int8 weights cached on a conv are rebuilt after load_state_dict."""
    plan = pair["plan"]
    path = next(p for p, r in plan.paths().items() if r == "int8_conv_f32")
    x = _nchw(pair["convs"][path][0])
    port = YOLOv10("yolov10n.yaml", device="cpu", seed=1)
    conv = port.model.get_submodule(path)
    p1 = plan_int8(port.model, (IMGSZ, IMGSZ), Int8Config(), one2many=True)
    with torch.no_grad():
        before = p1.run(conv, x, "int8_conv_f32")
        port.model.load_state_dict(pair["port"].model.state_dict())
        after = p1.run(conv, x, "int8_conv_f32")
        want = plan.run(_port_conv(pair, path), x, "int8_conv_f32")
    assert not torch.equal(before, after) and torch.equal(after, want)
