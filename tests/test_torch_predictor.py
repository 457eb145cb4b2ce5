"""End to end: the port's YOLOv10.predict against the JAX package's, yolov10n
at imgsz=128, same weights, same numpy images.

The JAX model is initialised by its facade; its variables are loaded into
the port (strict), calibrated there on the served images
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

from collections.abc import Mapping

import numpy as np
import pytest
import torch

from yolov10_3d_tpu.engine.model import YOLOv10 as JaxYOLOv10
from yolov10_3d_torch import YOLOv10
from yolov10_3d_torch.data.preprocess import preprocess_batch
from yolov10_3d_torch.utils.parity import calibrate, compare_results, smooth_images
from yolov10_3d_torch.utils.weights import _dotted, load_flax_variables

SCORE_TOL, BOX_TOL = 1e-4, 0.1
IMGSZ = 128
CONF = 0.01  # low enough that every image fills max_det: the top-k cut is compared too


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
    jm = JaxYOLOv10("yolov10n.yaml")
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
