"""End to end: the port's YOLOv10.predict against the JAX package's, yolov10n
at imgsz=128, same weights, same numpy images.

The JAX facade's variables come from ``jax_variables`` (flax's initial
values, the conv kernels from one ``jax.random`` draw of its ``lecun_normal``
distribution); they are loaded into the port (strict), calibrated there on the served images
(``utils/parity.calibrate``: untrained weights otherwise give every score
0.5 and top-k order is decided by rounding) and copied back into the JAX
tree. Both sides then serve a uniform batch (device letterbox) and a
mixed-shape list (host letterbox) at conf 0.01 and the default max_det 50,
with spd_serving False on both sides and, in a second test, True on both
sides (the fused stem kernel's twin here, the space-to-depth packed stem
there).

Bars: score error at most 1e-4 and box error at most 0.1 px, over the
detections whose score is more than 1e-4 clear of the selection boundaries
(``utils/parity.match_detections``). Both sides are float32 on the CPU; the
random net amplifies the two frameworks' rounding layer by layer. Measured
maxima on the CPU: scores 2.9e-5, boxes 2.3e-3 px.
"""

import functools
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from yolov10_3d_tpu.engine.model import YOLOv10 as JaxYOLOv10
from yolov10_3d_tpu.engine.model import _resolve_model_cfg
from yolov10_3d_tpu.nn import modules as JM
from yolov10_3d_tpu.nn.build import build_model as jax_build_model
from yolov10_3d_torch import YOLOv10
from yolov10_3d_torch.data.preprocess import preprocess_batch
from yolov10_3d_torch.utils.parity import calibrate, compare_results, smooth_images
from yolov10_3d_torch.utils.weights import _dotted, load_flax_variables

SCORE_TOL, BOX_TOL = 1e-4, 0.1
IMGSZ = 128
CONF = 0.01  # low enough that every image fills max_det: the top-k cut is compared too


_INIT_TREES: dict = {}


def _init_tree(model, args):
    """``model.init``'s tree of shapes for ``args``, traced once per model,
    input shapes and JAX int8 mode in a process (the test modules that one
    worker runs build the same models again and again)."""
    specs = jax.tree.map(lambda a: jax.ShapeDtypeStruct(np.shape(a), a.dtype), args)
    leaves, treedef = jax.tree.flatten(specs)
    key = (model, treedef, tuple(leaves), (JM._INT8_MODE, JM._INT8_SCOPE, JM._INT8_ACT_SCALE))
    try:
        tree = _INIT_TREES.get(key)
    except TypeError:  # a module with an unhashable field: traced every time
        key = tree = None
    if tree is None:
        tree = jax.eval_shape(lambda k, *a: model.init(k, *a, train=False),
                              jax.random.PRNGKey(0), *specs)
        if key is not None:
            _INIT_TREES[key] = tree
    return tree


@functools.partial(jax.jit, static_argnums=1)
def _kernel_draw(key, total):
    return jax.random.truncated_normal(key, -2.0, 2.0, (total,))


def jax_variables(model, *args, seed: int = 0):
    """Variables of the flax ``model`` as ``model.init(key, *args, train=False)``
    makes them, without compiling the init: its tree by ``jax.eval_shape``,
    every conv kernel from one ``jax.random`` draw of flax's ``lecun_normal``
    (a normal truncated at 2, scaled to std 1/sqrt(fan_in)), and flax's
    initial constants elsewhere (BatchNorm scale and variance 1, biases and
    means 0: every other leaf of the v10 and v10-3D trees). A jitted
    ``model.init`` compiles one initializer per kernel, 30 s or more on the
    CPU for yolov10n_3D whatever the input size; this compiles one draw.
    The arrays are new on every call."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(_init_tree(model, args))
    total = sum(leaf.size for path, leaf in leaves if path[-1].key == "kernel")
    draw = np.asarray(_kernel_draw(jax.random.PRNGKey(seed), total), np.float64)
    out, used = [], 0
    for path, leaf in leaves:
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            std = np.sqrt(1.0 / fan_in) / 0.87962566103423978  # flax's variance_scaling
            out.append((draw[used:used + leaf.size].reshape(leaf.shape) * std).astype(leaf.dtype))
            used += leaf.size
        elif name in ("scale", "var"):
            out.append(np.ones(leaf.shape, leaf.dtype))
        elif name in ("bias", "mean"):
            out.append(np.zeros(leaf.shape, leaf.dtype))
        else:
            raise ValueError(f"no initial value for the leaf {jax.tree_util.keystr(path)}")
    return jax.tree_util.tree_unflatten(treedef, out)


class JaxFacade(JaxYOLOv10):
    """The JAX facade ``YOLOv10(cfg)``, its variables from ``jax_variables``
    (traced at 64x64, as the facade initialises)."""

    def _new(self, cfg_name, nc=None):
        path = _resolve_model_cfg(cfg_name)
        self.model_cfg = str(path)
        self.model, self.spec = jax_build_model(str(path), nc=nc)
        if self.spec.head_module == "v10Detect3d":
            self.task = "detect3d"
        self.variables = jax_variables(self.model, jnp.zeros((1, 64, 64, 3), jnp.float32))
        self.names = {i: f"class{i}" for i in range(self.spec.nc)}


def port_to_flax(variables, module):
    """Write the port's weights back into a JAX variables tree of the same model."""
    sd = {k: v.detach().numpy() for k, v in module.state_dict().items()}

    def walk(tree, tokens, coll):
        if isinstance(tree, Mapping):
            return {k: walk(v, tokens + [k], coll) for k, v in tree.items()}
        prefix, leaf = _dotted(tokens[:-1]), tokens[-1]
        if coll == "batch_stats":
            return sd[f"{prefix}.{ {'mean': 'running_mean', 'var': 'running_var'}[leaf]}"]
        if leaf == "kernel":
            return sd[f"{prefix}.weight"].transpose(2, 3, 1, 0)
        return sd[f"{prefix}.{'weight' if leaf == 'scale' else leaf}"]

    return {c: walk(variables[c], [], c) for c in variables}


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    requests = {
        # uniform: downscaled through the antialiased device letterbox
        "uniform": (smooth_images(rng, [(96, 160)] * 2), 2),
        # mixed: host letterbox, shapes that need padding only
        "mixed": (smooth_images(rng, [(128, 96), (80, 128)]), 2),
    }
    jm = JaxFacade("yolov10n.yaml")
    port = YOLOv10("yolov10n.yaml", device="cpu")
    load_flax_variables(port.model, jm.variables)
    cal, _ = preprocess_batch([im for ims, _ in requests.values() for im in ims], IMGSZ)
    calibrate(port.model, torch.from_numpy(cal).permute(0, 3, 1, 2).contiguous())
    jm.variables = port_to_flax(jm.variables, port.model)
    return jm, port, requests


@pytest.mark.parametrize("request_name", ["uniform", "mixed"])
def test_predict_matches_jax(pair, request_name):
    jm, port, requests = pair
    imgs, batch = requests[request_name]
    want = jm.predict(imgs, imgsz=IMGSZ, batch=batch, conf=CONF, spd_serving=False)
    got = port.predict(imgs, imgsz=IMGSZ, batch=batch, conf=CONF, spd_serving=False)
    assert [r.orig_shape for r in got] == [im.shape[:2] for im in imgs]
    stats = compare_results(want, got, conf=CONF, score_tol=SCORE_TOL, box_tol=BOX_TOL)
    # most detections are separated, so the comparison is not vacuous
    assert stats["n_compared"] >= 0.5 * (stats["n_ref"] + stats["n_got"]), stats
    assert stats["max_score_err"] <= SCORE_TOL and stats["max_box_err"] <= BOX_TOL


@pytest.mark.parametrize("request_name", ["uniform", "mixed"])
def test_predict_spd_serving_matches_jax(pair, request_name):
    """The default serving route on both sides: the port's fused stem (its
    twin on the CPU, BatchNorm folded) against JAX's packed stem."""
    jm, port, requests = pair
    imgs, batch = requests[request_name]
    want = jm.predict(imgs, imgsz=IMGSZ, batch=batch, conf=CONF, spd_serving=True)
    got = port.predict(imgs, imgsz=IMGSZ, batch=batch, conf=CONF, spd_serving=True)
    stats = compare_results(want, got, conf=CONF, score_tol=SCORE_TOL, box_tol=BOX_TOL)
    assert stats["n_compared"] >= 0.5 * (stats["n_ref"] + stats["n_got"]), stats


def test_calibrated_scores_are_spread(pair):
    """The calibration does what the comparison needs: no saturated or tied
    top-k scores on the served images."""
    _, port, requests = pair
    for imgs, batch in requests.values():
        for r in port.predict(imgs, imgsz=IMGSZ, batch=batch, conf=CONF):
            s = np.sort(r.boxes.conf)
            assert len(s) and s.max() < 1.0 and np.median(np.diff(s)) > SCORE_TOL
