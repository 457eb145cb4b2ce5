"""The depthwise int8 conv from float input (``kernels/int8.py``
``int8_dw_conv_f32``: its twin on the CPU; tests/test_torch_kernels.py holds
the CUDA kernel to the twin on the card) against the JAX package's
``int8_conv(groups=C)`` and ``Conv`` under ``set_int8_mode(True, act_scale,
"all")``, and ``Int8Plan.run``'s hand-over to it.

Cases: 3x3 at stride 1 and 2 and the 7x7 on odd planes (13x11), a 3x3 on a
20x16 plane; the static scale (8/127) and the dynamic one.

Bars, the bars of tests/test_torch_int8_group.py:
- the twin's int32 sums, dequantized (epilogue deq only), equal
  ``int8_conv``'s bit for bit;
- the gated ``Conv`` (BatchNorm away from identity, SiLU) against the JAX
  ``Conv``: rtol 1e-5 and atol 1e-5 (XLA's fused BatchNorm and its rsqrt
  and logistic differ from torch's by an ulp after bit-exact sums).

At most five tests: tests/test_train3d_e2e.py has six, and the Tier-1
scheduler hands out files with more tests first (ROADMAP).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from test_torch_int8 import _nchw
from test_torch_int8_all import jax_int8_mode
from yolov10_3d_tpu.nn import modules as JM
from yolov10_3d_torch import YOLOv10
from yolov10_3d_torch.kernels import int8 as K8
from yolov10_3d_torch.nn import modules as M
from yolov10_3d_torch.nn import quant as Q
from yolov10_3d_torch.nn.quant import STATIC_ACT_SCALE, Int8Config, Int8Plan, plan_int8
from yolov10_3d_torch.utils.weights import load_flax_variables

# (channels, kernel, stride, H, W)
DW_CASES = [(16, 3, 1, 13, 11), (16, 3, 2, 13, 11), (8, 7, 1, 13, 11), (12, 3, 1, 20, 16)]


def _conv_plan(conv, hw, cfg, codes_in=frozenset()):
    return Int8Plan(cfg, {conv: hw}, {conv: "int8_group_conv_f32"}, {conv: "conv"}, codes_in)


@pytest.mark.parametrize("act_scale", [STATIC_ACT_SCALE, None], ids=["static", "dynamic"])
def test_dw_route_matches_jax(act_scale):
    """Each case: the new route's twin from float NCHW input (deq-only
    epilogue) against JAX's jitted ``int8_conv`` with ``groups=C``, bit for
    bit; then a depthwise ``Conv`` through ``Int8Plan.run`` (which takes the
    new route) against the JAX ``Conv`` under ``set_int8_mode(True,
    act_scale, "all")``, rtol 1e-5 and atol 1e-5."""
    for c, k, s, H, W in DW_CASES:
        rng = np.random.default_rng(c * 100 + k * 10 + s)
        x = (rng.normal(0, 1.5, (2, H, W, c)) * rng.uniform(0.2, 1, c)).astype(np.float32)
        w = rng.normal(0, 0.3, (k, k, 1, c)).astype(np.float32)
        p = k // 2
        f = jax.jit(lambda x, w: JM.int8_conv(x, w, (s, s), ((p, p), (p, p)), groups=c,
                                              act_scale=act_scale))
        want = np.asarray(f(jnp.asarray(x), jnp.asarray(w)))
        wq, sw = Q.quantize_weight(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
        zero, one = torch.zeros(c), torch.ones(c)
        deq = sw * np.float32(act_scale) if act_scale is not None else zero
        ep = torch.stack([deq, zero, one, zero]).float().contiguous()
        got = K8.int8_dw_conv_f32(_nchw(x), wq.permute(0, 2, 3, 1).contiguous(), ep, sw,
                                  act_scale, s, p, 1, False)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want, err_msg=str(k))

        jconv = JM.Conv(c, k, s, g=c)
        v = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x))
        v = jax.tree.map(lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape)
                         .astype(np.float32) if a.ndim == 1 else np.asarray(a), v)
        with jax_int8_mode("all", act_scale):
            want = np.asarray(jax.jit(lambda v, x: jconv.apply(v, x))(v, jnp.asarray(x)))
        conv = load_flax_variables(M.Conv(c, c, k, s, g=c), v)
        plan = _conv_plan(conv, H * W, Int8Config(act_scale=act_scale, scope="all"))
        assert plan.launches()["int8_dw_conv_f32"] == 1
        assert plan.launches()["int8_act_absmax"] == (act_scale is None)
        with torch.no_grad():
            got = conv(_nchw(x), plan).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=str(k))


def _recording(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def record(x, *args):
        calls.append(x)
        return fn(x, *args)

    monkeypatch.setattr(module, name, record)


def test_run_hands_float_nchw_to_the_dw_route(monkeypatch):
    """yolov10n at 64x64, scope all, static and dynamic: every depthwise
    conv reaches ``int8_dw_conv_f32`` with its float32 NCHW input as it
    arrives (the tensor the Conv received), once per conv as
    ``plan.launches()`` says; ``quantize_act`` runs for the other gated
    convs given float input only, and the codes-in entry is not called."""
    model = YOLOv10("yolov10n.yaml", device="cpu", seed=0).model
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (2, 3, 64, 64))
                         .astype(np.float32))
    for cfg in (Int8Config(scope="all"), Int8Config(act_scale=None, scope="all")):
        plan = plan_int8(model, (64, 64), cfg)
        dws = [c for c in plan.routes if c.conv.groups == c.conv.in_channels > 1]
        inputs = {}
        hooks = [c.register_forward_pre_hook(lambda m, a: inputs.__setitem__(m, a[0]))
                 for c in dws]
        dw_calls, group_calls, quantized = [], [], []
        with monkeypatch.context() as mp:
            _recording(mp, K8, "int8_dw_conv_f32", dw_calls)
            _recording(mp, K8, "int8_group_conv_f32", group_calls)
            _recording(mp, Q, "quantize_act", quantized)
            with torch.no_grad():
                model(x, fast_eval=True, int8=cfg)
        for h in hooks:
            h.remove()
        want = plan.launches()
        assert len(dw_calls) == want["int8_dw_conv_f32"] == len(dws) == 14
        assert want["int8_act_absmax"] == (14 if cfg.act_scale is None else 0)
        assert group_calls == [] and want["int8_group_conv_f32"] == 0
        for t in dw_calls:
            assert t.dtype == torch.float32 and t.dim() == 4 and t[0].is_contiguous()
        assert {id(t) for t in dw_calls} == {id(t) for t in inputs.values()}
        # one quantize_act for each gated conv given float input but the depthwise ones
        assert len(quantized) == len(plan.routes) - len(dws) - len(plan.codes_in)


def test_codes_in_and_general_groups_keep_the_codes_in_entry(monkeypatch):
    """A depthwise conv fed int8 NHWC codes by a fused producer, and a
    grouped conv with C / g = 4 given float input, take the codes-in entry
    ``int8_group_conv_f32`` (its twin here), as ``plan.launches()`` says."""
    rng = np.random.default_rng(5)
    calls = []
    monkeypatch.setattr(K8, "int8_dw_conv_f32", None)  # must not be reached
    _recording(monkeypatch, K8, "int8_group_conv_f32", calls)
    dw = M.Conv(16, 16, 3, 1, g=16).eval()
    plan = _conv_plan(dw, 63, Int8Config(scope="all"), frozenset({dw}))
    assert plan.launches()["int8_group_conv_f32"] == 1 and plan.launches()["int8_dw_conv_f32"] == 0
    codes = torch.from_numpy(rng.integers(-127, 128, (2, 9, 7, 16)).astype(np.int8))
    with torch.no_grad():
        got = plan.run(dw, codes, "int8_group_conv_f32")
    w = Q._weights(dw, STATIC_ACT_SCALE)
    want = K8.int8_group_conv_f32_torch(codes, w.w, w.ep, 1, 1, 1, 16, True)
    assert len(calls) == 1 and torch.equal(got, want)

    grouped = M.Conv(16, 16, 3, 2, g=4).eval()
    plan = _conv_plan(grouped, 63, Int8Config(act_scale=None, scope="all"))
    assert plan.launches()["int8_group_conv_f32"] == 1 and plan.launches()["int8_act_absmax"] == 0
    x = torch.from_numpy(rng.normal(0, 2, (2, 16, 9, 7)).astype(np.float32))
    with torch.no_grad():
        got = plan.run(grouped, x, "int8_group_conv_f32")
    assert len(calls) == 2 and got.shape == (2, 16, 5, 4) and torch.isfinite(got).all()


def test_shipped_plans_run_every_grouped_conv_on_the_dw_kernel():
    """Every YOLOv10 and YOLOv10-3D YAML (n to x) at scope all: each conv on
    the grouped route is depthwise and fed float input, so the codes-in
    entry has no launch; YOLOv10-S at 640x640 makes 18 launches of the new
    kernel a forward and YOLOv10-S-3D at 384x1280 12. Each distinct shape of
    those two plans gets a tile at B = 1, 8 and 32 that fits a block's
    shared memory, with two blocks an SM at B = 8."""
    want = {("yolov10s.yaml", (640, 640)): 18, ("yolov10s_3D.yaml", (384, 1280)): 12}
    for scale in "nsmblx":
        for yaml, hw in ((f"yolov10{scale}.yaml", (640, 640)),
                         (f"yolov10{scale}_3D.yaml", (384, 1280))):
            model = YOLOv10(yaml, device="cpu", seed=0).model
            plan = plan_int8(model, hw, Int8Config(scope="all"), stem=True)
            n = plan.launches()
            assert n["int8_group_conv_f32"] == 0, yaml
            assert n["int8_dw_conv_f32"] == plan.counts()["int8_group_conv_f32"] > 0, yaml
            if (yaml, hw) not in want:
                continue
            assert n["int8_dw_conv_f32"] == want[yaml, hw]
            for conv, route in plan.routes.items():
                if route != "int8_group_conv_f32":
                    continue
                c = conv.conv
                st = round((hw[0] * hw[1] / plan.hw[conv]) ** 0.5)
                for B in (1, 8, 32):
                    t = K8.dw_tiles(B, c.in_channels, hw[0] // st, hw[1] // st,
                                    *c.kernel_size, c.stride[0], c.padding[0], c.dilation[0])
                    assert t.smem <= K8.DW_SMEM_MAX and t.planes * t.rows >= 1
                    assert B != 8 or t.blocks >= 2 * K8.SMS, (B, c, t)
