"""The Predictor's captured serving forward (``engine/predictor.py``): one
CUDA graph per key, at most ``GRAPH_CACHE`` of them, replayed on the card.

Imports torch and the port only, so it also runs on the card, where JAX is
absent: ``python -m pytest --noconftest tests/test_torch_graphs.py``.

On the CPU: the graph key differs in each field that shapes the forward,
the cache drops its least recently used graph beyond 8, a CPU model
captures nothing, the facade keeps its Predictor from one call to the next
and drops it after ``train``, and a Predictor drops its graphs when a
weight changes. Marked ``cuda`` (skipped without a card): the replayed
forward equals the eager one bit for bit (``torch.equal``) for 2D float32,
2D int8, 3D sparse and 3D dense; a replay with a new input gives that
input's output; the launch counts follow the replay rule; a capture in a
fresh process builds no kernel inside the capture.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from yolov10_3d_torch import YOLOv10
from yolov10_3d_torch.cfg import get_cfg
from yolov10_3d_torch.engine import model as facade_module
from yolov10_3d_torch.engine.predictor import GRAPH_CACHE, Predictor
from yolov10_3d_torch.kernels import launch_counts, reset_launch_counts
from yolov10_3d_torch.utils.parity import calibrate

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def models():
    return {"2d": YOLOv10("yolov10n.yaml", device="cpu"),
            "3d": YOLOv10("yolov10n_3D.yaml", device="cpu")}


def _pred(model, **kw):
    return Predictor(model.model, model.spec, get_cfg(kw), model.names)


def test_graph_key_covers_every_setting(models):
    m2, m3 = models["2d"], models["3d"]
    x = torch.zeros((1, 3, 64, 64))
    base = _pred(m2)
    variants = {
        "shape": base.graph_key(torch.zeros((2, 3, 64, 64)), 50),
        "dtype": base.graph_key(x.double(), 50),
        "max_det": base.graph_key(x, 51),
        "int8": _pred(m2, int8=True).graph_key(x, 50),
        "stem": _pred(m2, spd_serving=False).graph_key(x, 50),
    }
    keys = [base.graph_key(x, 50), *variants.values()]
    assert len(set(keys)) == len(keys), variants
    assert base.graph_key(x, 50) == _pred(m2).graph_key(x.clone(), 50)
    p3 = _pred(m3)
    sparse, dense = p3.graph_key(x, 50), p3.graph_key(x, 100)
    assert sparse[-1] is True and dense[-1] is False
    assert p3.graph_key(x, 50) != p3.graph_key(x, 51) and sparse[:2] == dense[:2]


def test_cache_drops_least_recently_used(models):
    pred = _pred(models["2d"])
    for i in range(GRAPH_CACHE):
        pred.remember(i, f"graph {i}")
    pred.graphs.move_to_end(0)  # key 0 used again: 1 is now the oldest
    pred.remember(GRAPH_CACHE, "new")
    assert GRAPH_CACHE == 8 and len(pred.graphs) == 8
    assert 1 not in pred.graphs and 0 in pred.graphs and list(pred.graphs)[-1] == GRAPH_CACHE


def test_cpu_model_captures_nothing(models, monkeypatch):
    def no_graph(*a, **k):
        raise AssertionError("a CPU model must not capture")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_graph)
    monkeypatch.setattr(torch.cuda, "graph", no_graph)
    img = np.full((48, 64, 3), 100, np.uint8)
    m = models["2d"]
    m.predictors.clear()
    for _ in range(2):
        m.predict(img, imgsz=64, conf=0.01)
    (pred,) = m.predictors.values()
    assert not pred.graphs


def test_facade_keeps_its_predictors(models):
    """One Predictor per forward-shaping setting, kept from one call to the
    next; conf, max_det and imgsz come with each call."""
    m = models["2d"]
    m.predictors.clear()
    img = np.full((48, 64, 3), 100, np.uint8)
    a = m.predict(img, imgsz=64, conf=0.01)
    pred = m.predictors[(False, True)]
    b = m.predict(img, imgsz=64, conf=0.4, max_det=10)
    assert m.predictors[(False, True)] is pred and len(a[0]) > len(b[0]) <= 10
    m.predict(img, imgsz=64, int8=True)
    m.predict(img, imgsz=64, spd_serving=False)
    assert set(m.predictors) == {(False, True), (True, True), (False, False)}
    assert m.predictors[(False, True)] is pred


def test_facade_drops_predictors_after_train(models, monkeypatch):
    m = models["2d"]
    m.predict(np.full((48, 64, 3), 100, np.uint8), imgsz=64)
    assert m.predictors

    class Trainer:
        def __init__(self, args):
            self.spec, self.names = m.spec, {0: "a"}

        def train(self):
            return "state"

        def eval_model(self):
            return m.model

    monkeypatch.setattr(facade_module, "DetectionTrainer", Trainer)
    assert m.train(data="unused.yaml") == "state"
    assert m.predictors == {}


def test_predictor_drops_graphs_when_weights_change(models):
    """A graph reads the tensors it was captured on: an in-place change
    (calibration, load_state_dict) or a new storage drops every graph."""
    m = models["2d"]
    pred = _pred(m)
    img = np.full((48, 64, 3), 100, np.uint8)
    for change in ("calibrate", "load", "none"):
        pred.remember("key", "graph")
        if change == "calibrate":
            calibrate(m.model, torch.rand((1, 3, 64, 64)))
        elif change == "load":
            m.model.load_state_dict(m.model.state_dict())
        pred(img, imgsz=64)
        assert ("key" in pred.graphs) == (change == "none"), change


# ------------------------------------------------------------ on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the captured forward is a CUDA graph; run on the card")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


CASES = {  # name -> (yaml, predict settings, input (B, H, W), max_det)
    "2d_float32": ("yolov10n.yaml", {}, (2, 128, 128), 50),
    "2d_int8": ("yolov10n.yaml", {"int8": True}, (2, 128, 128), 50),
    "3d_sparse": ("yolov10n_3D.yaml", {}, (2, 128, 608), 50),
    "3d_dense": ("yolov10n_3D.yaml", {}, (2, 128, 608), 100),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_replay_equals_eager(card, case):
    cfg, kw, (B, H, W), max_det = CASES[case]
    model = YOLOv10(cfg, device="cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(0)
    xs = [torch.rand((B, 3, H, W), generator=g, device="cuda") for _ in range(3)]
    calibrate(model.model, xs[0])
    pred = model.predictor(get_cfg(kw))
    reset_launch_counts()
    first = pred._forward(xs[0], max_det)  # eager, then the capture
    eager_counts = dict(launch_counts)
    (cap,) = pred.graphs.values()
    assert cap.launches == eager_counts  # the capture counted itself out again
    assert eager_counts["stem_conv"] == 1
    assert eager_counts["decode_detect"] == (1 if cfg == "yolov10n.yaml" else 0)
    assert (eager_counts["int8_conv_f32"] > 0) == ("int8" in kw)
    for x in xs[1:] + xs[:1]:  # new inputs, then the first again: no stale buffer
        reset_launch_counts()
        replayed = pred._forward(x, max_det)
        assert dict(launch_counts) == eager_counts  # one replay counts as one launch each
        eager = pred.forward_eager(x, max_det).cpu()
        assert torch.equal(torch.from_numpy(replayed), eager), case
    assert np.array_equal(first, replayed)
    assert len(pred.graphs) == 1


_FRESH = """
import numpy as np, torch
from yolov10_3d_torch import YOLOv10
from yolov10_3d_torch.kernels import _build
calls = []
real = _build.build
def build(names):
    calls.append((tuple(names), torch.cuda.is_current_stream_capturing()))
    return real(names)
_build.build = build  # every kernel's first load goes through it
m = YOLOv10("yolov10n.yaml", device="cuda")
img = np.full((96, 128, 3), 90, np.uint8)
for int8 in (False, True):
    for _ in range(3):
        m.predict(img, imgsz=128, int8=int8)
assert calls and not any(c for _, c in calls), calls
assert all(len(p.graphs) == 1 for p in m.predictors.values())
print("fresh ok", sorted({n for n, _ in calls}))
"""


@pytest.mark.cuda
def test_fresh_process_builds_nothing_inside_a_capture(card):
    out = subprocess.run([sys.executable, "-c", _FRESH], cwd=REPO, capture_output=True,
                         text=True, timeout=600, env=dict(os.environ))
    assert out.returncode == 0 and "fresh ok" in out.stdout, out.stderr[-3000:]
