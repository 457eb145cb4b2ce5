"""YOLOv8's YAMLs, ``Proto`` and the ``Detect``, ``Segment``, ``Pose`` and
``OBB`` heads of the port against the JAX package's: parameter counts and
specs of yolov8, -p6, -seg, -pose and -obb (scale n), ``Proto`` alone (its
transposed conv's kernel moved by ``utils/weights.py`` with no spatial
flip), each head's raw maps on the same features, the whole yolov8n-seg at 128 px
and yolov8n-p6 at 256, and the weight round trip, loaded strict.

Bars (PARITY.md 2.1-2.2): a block's forward 2e-4, a head's maps 3e-4 (max
abs over outputs of order 1; the whole models are calibrated first, as in
``tests/test_torch_predictor.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from test_torch_predictor import jax_variables, port_to_flax
from yolov10_3d_tpu.nn import heads as JH
from yolov10_3d_tpu.nn import modules as JM
from yolov10_3d_tpu.nn.build import build_model as jax_build_model
from yolov10_3d_torch.cfg import resolve_model_cfg
from yolov10_3d_torch.nn import heads as H
from yolov10_3d_torch.nn import modules as M
from yolov10_3d_torch.nn.build import build_model
from yolov10_3d_torch.utils.parity import calibrate, smooth_images
from yolov10_3d_torch.utils.weights import (flax_to_torch_state_dict, load_flax_variables,
                                            torch_to_flax_variables)

BLOCK_TOL, HEAD_TOL = 2e-4, 3e-4
YAMLS = ("yolov8.yaml", "yolov8-p6.yaml", "yolov8-seg.yaml", "yolov8-pose.yaml",
         "yolov8-obb.yaml")


def _nchw(a):
    return torch.from_numpy(np.asarray(a)).permute(0, 3, 1, 2).contiguous()


def _maps(out):
    """A head output (list or dict of lists and arrays) as a flat list, dict keys sorted."""
    if isinstance(out, dict):
        return [m for k in sorted(out) for m in (out[k] if isinstance(out[k], list)
                                                 else [out[k]])]
    return list(out)


def _max_err(want, got):
    want, got = _maps(want), _maps(got)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert tuple(g.shape) == tuple(np.asarray(w).transpose(0, 3, 1, 2).shape)
    return max(float(np.abs(np.asarray(w).transpose(0, 3, 1, 2) - g.detach().numpy()).max())
               for w, g in zip(want, got))


def test_v8_yamls_build_as_jax():
    """Each YAML: the JAX parameter count, strides and head args; the JAX
    variables load strict."""
    for name in YAMLS:
        jm, jspec = jax_build_model(f"yolov10_3d_tpu/cfg/models/v8/{name}")
        v = jax_variables(jm, jnp.zeros((1, 64, 64, 3), jnp.float32))
        model, spec = build_model(resolve_model_cfg(name), device="cpu")
        n_jax = sum(a.size for a in jax.tree_util.tree_leaves(v["params"]))
        assert sum(p.numel() for p in model.parameters()) == n_jax, name
        assert spec.strides == jspec.strides and spec.head_module == jspec.head_module
        assert spec.layers[-1].args[2:] == jspec.layers[-1].args[2:], name
        assert [(s.module, s.c2, s.stride) for s in spec.layers] == [
            (s.module, s.c2, s.stride) for s in jspec.layers], name
        load_flax_variables(model, v)


def test_proto_matches_jax():
    """Proto alone on unit-scale input; c_ != c2 so that a swapped or
    flipped transposed-conv kernel shows."""
    x = np.random.default_rng(0).standard_normal((2, 8, 8, 16)).astype(np.float32)
    jp = JM.Proto(24, 8)
    v = jax_variables(jp, jnp.zeros((1, 8, 8, 16), jnp.float32))
    # non-trivial BatchNorm statistics, as a trained or calibrated net has
    rng = np.random.default_rng(1)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a), v)
    for leaf in ("cv1", "cv2", "cv3"):
        bs = v["batch_stats"][leaf]["bn"]
        bs["mean"] = rng.normal(size=bs["mean"].shape).astype(np.float32) * 0.3
        bs["var"] = rng.uniform(0.5, 2, bs["var"].shape).astype(np.float32)
    v["params"]["upsample"]["bias"] = rng.normal(size=24).astype(np.float32)
    want = jax.jit(lambda v, x: jp.apply(v, x, train=False))(v, x)
    port = M.Proto(16, 24, 8).eval()
    load_flax_variables(port, v)
    with torch.no_grad():
        got = port(_nchw(x))
    assert float(np.abs(np.asarray(want)).max()) > 0.1
    assert _max_err([want], [got]) < BLOCK_TOL


def test_heads_match_jax():
    """Each v8 head's raw maps on the same three scales of unit-scale features."""
    rng = np.random.default_rng(2)
    ch = (16, 32, 64)
    xs = [rng.standard_normal((2, 8 >> i, 8 >> i, c)).astype(np.float32) for i, c in enumerate(ch)]
    cases = [(JH.Detect(nc=3, ch=ch), H.Detect(3, ch)),
             (JH.Segment(nc=3, ch=ch, nm=8, npr=24), H.Segment(3, ch, 8, 24)),
             (JH.Pose(nc=1, ch=ch, kpt_shape=(5, 3)), H.Pose(1, ch, (5, 3))),
             (JH.OBB(nc=3, ch=ch, ne=1), H.OBB(3, ch, 1))]
    for jhead, head in cases:
        v = jax_variables(jhead, [jnp.asarray(x) for x in xs])
        want = jax.jit(lambda v, xs, jhead=jhead: jhead.apply(v, xs, train=False))(v, xs)
        load_flax_variables(head.eval(), v)
        with torch.no_grad():
            got = head([_nchw(x) for x in xs])
        assert type(got) is type(want)
        assert _max_err(want, got) < HEAD_TOL, type(head).__name__


def test_v8_models_match_jax():
    """yolov8n-seg at 128 px and yolov8n-p6 (four scales, C2 blocks) at 256
    (its P6 maps 4x4: at 128 they are 2x2, and BatchNorm statistics
    calibrated on 8 values a channel amplify rounding past the bar),
    calibrated on the input: every raw map within the heads' bar."""
    for name, size in (("yolov8-seg.yaml", 128), ("yolov8-p6.yaml", 256)):
        imgs = np.stack(smooth_images(np.random.default_rng(3), [(size, size)] * 2))
        x = imgs.astype(np.float32) / 255.0
        jm, _ = jax_build_model(f"yolov10_3d_tpu/cfg/models/v8/{name}")
        v = jax_variables(jm, jnp.zeros((1, 64, 64, 3), jnp.float32))
        model, _ = build_model(resolve_model_cfg(name), device="cpu")
        load_flax_variables(model, v)
        calibrate(model, _nchw(x))
        v = port_to_flax(v, model)
        want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, x)
        with torch.no_grad():
            got = model(_nchw(x))
        assert max(float(np.abs(np.asarray(m)).max()) for m in _maps(want)) > 1.0
        assert _max_err(want, got) < HEAD_TOL, name


def test_v8_weights_round_trip_strict():
    """flax -> the port's state_dict -> flax gives the JAX tree back, leaf
    for leaf (Proto's transposed kernel included), and every key loads
    strict."""
    for name in YAMLS:
        jm, _ = jax_build_model(f"yolov10_3d_tpu/cfg/models/v8/{name}")
        v = jax_variables(jm, jnp.zeros((1, 64, 64, 3), jnp.float32))
        sd = flax_to_torch_state_dict(v)
        model, _ = build_model(resolve_model_cfg(name), device="cpu")
        assert set(sd) == set(model.state_dict()), name
        back = torch_to_flax_variables(sd)
        flat_v = jax.tree_util.tree_flatten_with_path(v)[0]
        flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
        assert len(flat_v) == len(flat_b)
        for path, leaf in flat_v:
            assert np.array_equal(np.asarray(leaf), np.asarray(flat_b[path])), path
