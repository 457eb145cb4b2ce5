"""The 3D head's YAML options in the port (``nn/heads3d.py``: ``dsconv``,
``use_predecessors``, ``common_head``, ``half_channels``, ``deform``, and
the dep embeddings) against the JAX package's ``V10Detect3d`` on the CPU.

The head at yolov10n-3D's widths (P3/P4/P5 of 64/128/256 channels, every
branch 128 wide) on seeded features of a 96x320 input, each option alone
and in the combinations the YAMLs allow, with JAX variables from
``test_torch_predictor.jax_variables`` (the deform offset and modulator
convs drawn too, so their offsets are non-zero) and BatchNorm statistics
drawn. Bars (PARITY.md section 2.2, the head bar): one2one and one2many maps
and the o2m/o2o embeddings 3e-4 + 3e-4 |y|. A sparse request outside the
sparse envelope gives the dense maps exactly (JAX
``tests/test_sparse_infer3d.py`` ``test_envelope_fallback_predecessors``);
inside it (``half_channels``) the port's sparse maps are JAX's sparse maps
at the same bar. The whole yolov10n-3D of each option set loads JAX's tree
``strict=True`` and ``torch_to_flax_variables`` gives that tree back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from test_torch_predictor import jax_variables
from yolov10_3d_tpu.nn.build import build_model as jax_build_model
from yolov10_3d_tpu.nn.heads3d import V10Detect3d as JaxHead
from yolov10_3d_tpu.utils.torch_export import flax_to_torch_state_dict as jax_export_sd
from yolov10_3d_torch import YOLOv10
from yolov10_3d_torch.engine.validator3d import Detection3DValidator
from yolov10_3d_torch.nn.build import build_model, init_weights
from yolov10_3d_torch.nn.heads3d import V10Detect3d
from yolov10_3d_torch.utils.weights import load_flax_variables, torch_to_flax_variables

CH = (64, 128, 256)
NC = 3
B = 1
HEAD_TOL = 3e-4
OPTIONS = {
    "dsconv": {"dsconv": True},
    "use_predecessors": {"use_predecessors": True},
    "common_head": {"common_head": True},
    "half_channels": {"half_channels": True},
    "deform": {"deform": True},
    "dsconv+use_predecessors+half_channels": {"dsconv": True, "use_predecessors": True,
                                              "half_channels": True},
    "common_head+dsconv": {"common_head": True, "dsconv": True},
}
JAX_YAML = "yolov10_3d_tpu/cfg/models/v10-3D/yolov10n_3D.yaml"
PORT_YAML = "yolov10_3d_torch/cfg/models/v10-3D/yolov10n_3D.yaml"


def _cfg(opts):
    return {"channels": {}, "num_scales": 3, **opts}


def _features(seed, hw):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, h, w, c)).astype(np.float32) for (h, w), c in zip(hw, CH)]


def _variables(module, xs, seed):
    """jax_variables with BatchNorm scales, biases and statistics drawn."""
    rng = np.random.default_rng(seed)
    v = jax_variables(module, [jnp.asarray(x) for x in xs])
    return jax.tree_util.tree_map_with_path(
        lambda p, a: (np.asarray(a) if p[-1].key == "kernel" else
                      rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
                      if p[-1].key in ("scale", "var") else
                      rng.normal(0, 0.1, a.shape).astype(np.float32)), v)


def _nchw(xs):
    return [torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))) for x in xs]


def _close(got, want, msg):
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=HEAD_TOL, atol=HEAD_TOL, err_msg=msg)


def _pair(opts, hw, seed=0):
    xs = _features(seed, hw)
    jm = JaxHead(nc=NC, ch=CH, cfg=tuple(_cfg(opts).items()))
    variables = _variables(jm, xs, seed + 1)
    pm = V10Detect3d(NC, CH, _cfg(opts)).eval()
    load_flax_variables(pm, variables)
    return xs, jm, variables, pm


@pytest.mark.parametrize("name", list(OPTIONS))
def test_head_option_matches_jax(name):
    """one2one and one2many maps and the dep embeddings at 96x320's grids."""
    xs, jm, variables, pm = _pair(OPTIONS[name], [(12, 40), (6, 20), (3, 10)])
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, [jnp.asarray(x) for x in xs])
    with torch.no_grad():
        got = pm(_nchw(xs))
    for key in ("one2one", "one2many"):
        for i, (g, w) in enumerate(zip(got[key], want[key])):
            _close(g, w, f"{key}[{i}]")
    for key in ("o2m_embs", "o2o_embs"):
        for i, (g, w) in enumerate(zip(got[key], want[key])):
            assert (g is None) == (w is None) == ("common_head" in name), (key, i)
            if g is not None:
                _close(g, w, f"{key}[{i}]")
    if "half_channels" in name:
        assert pm.dep[0][-1].in_channels == 64  # mid2 = mid // 2


@pytest.mark.parametrize("name", [n for n in OPTIONS if n != "half_channels"])
def test_sparse_request_outside_envelope_is_dense(name):
    """A sparse request on a head outside the sparse envelope runs the dense
    head: its maps equal the dense request's exactly. With
    use_predecessors (JAX's own envelope test) JAX's sparse model of the
    same head falls back the same way: the port's maps are its maps within
    the head bar."""
    hw = [(32, 40), (16, 20), (8, 10)]  # P3 large enough for the sparse path
    if name == "use_predecessors":
        xs, jm, variables, pm = _pair(OPTIONS[name], hw, seed=3)
    else:  # the port alone: its own seeded weights
        xs = _features(3, hw)
        pm = init_weights(V10Detect3d(NC, CH, _cfg(OPTIONS[name])),
                          torch.Generator().manual_seed(3)).eval()
    assert not pm.sparse_ok
    with torch.no_grad():
        dense = pm(_nchw(xs), one2many=False)["one2one"]
        sparse = pm(_nchw(xs), one2many=False, sparse=True)["one2one"]
    assert all(torch.equal(a, b) for a, b in zip(dense, sparse))
    if name != "use_predecessors":
        return
    js = JaxHead(nc=NC, ch=CH, cfg=tuple(_cfg(OPTIONS[name]).items()), sparse_eval=True,
                 eval_one2many=False)
    want = jax.jit(lambda v, x: js.apply(v, x, train=False))(
        variables, [jnp.asarray(x) for x in xs])["one2one"]
    for i, (g, w) in enumerate(zip(sparse, want)):
        _close(g, w, f"one2one[{i}]")


def test_sparse_inside_envelope_matches_jax_sparse():
    """half_channels stays sparse: the port's sparse maps against JAX's
    sparse maps (the same top-50 candidates; zero elsewhere)."""
    hw = [(32, 40), (16, 20), (8, 10)]
    xs, jm, variables, pm = _pair(OPTIONS["half_channels"], hw, seed=5)
    assert pm.sparse_ok
    js = JaxHead(nc=NC, ch=CH, cfg=tuple(_cfg(OPTIONS["half_channels"]).items()),
                 sparse_eval=True, eval_one2many=False)
    want = jax.jit(lambda v, x: js.apply(v, x, train=False))(
        variables, [jnp.asarray(x) for x in xs])["one2one"]
    with torch.no_grad():
        got = pm(_nchw(xs), one2many=False, sparse=True)["one2one"]
        dense = pm(_nchw(xs), one2many=False)["one2one"]
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"one2one[{i}]")
    off = (got[0][:, NC:] == 0).all(1)  # P3 ran sparse: zero regression off the candidates
    assert int((~off).sum()) == B * 50 and not torch.equal(got[0], dense[0])


@pytest.mark.parametrize("name", [n for n in OPTIONS if "+" not in n])
def test_model_with_option_loads_jax_tree(name, tmp_path):
    """yolov10n-3D with the option in its YAML: JAX's whole tree loads
    strict, round-trips through ``torch_to_flax_variables``, and the
    Predictor and the 3D validator report the route the head runs."""
    extra = "".join(f"{k}: true\n" for k in OPTIONS[name])
    jy, py = tmp_path / "j.yaml", tmp_path / "p.yaml"
    jy.write_text(open(JAX_YAML).read() + extra)
    py.write_text(open(PORT_YAML).read() + extra)
    jm, _ = jax_build_model(str(jy), nc=NC)
    variables = jax_variables(jm, jnp.zeros((1, 96, 320, 3), jnp.float32))
    model, spec = build_model(py, nc=NC, device="cpu")
    load_flax_variables(model, variables)
    back = torch_to_flax_variables(model.state_dict())
    want = jax.tree_util.tree_flatten_with_path(variables)[0]
    got = jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, back))[0]
    assert [jax.tree_util.keystr(k) for k, _ in got] == [jax.tree_util.keystr(k) for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=jax.tree_util.keystr(k))
    port = YOLOv10(str(py), device="cpu")
    pred = port.predictor({"int8": False, "spd_serving": True})
    assert pred.sparse(50) == ("half_channels" == name)
    route = Detection3DValidator(port.model, port.spec).route(50, False)
    assert route == ("sparse" if name == "half_channels" else "dense")
    if "deform" in name:  # the JAX .pt export spells the modulator "modulator.conv"
        sd = jax_export_sd(variables)
        assert any(".modulator.conv.weight" in k for k in sd)
        port._load_reference_state({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
        head = port.model.model[spec.head_index]
        np.testing.assert_array_equal(
            head.dep[0][0].conv.modulator_conv.weight.detach().numpy(),
            np.asarray(variables["params"][f"model_{spec.head_index}"]["dep_0_0"]["conv"]
                       ["modulator_conv"]["kernel"]).transpose(3, 2, 0, 1))
