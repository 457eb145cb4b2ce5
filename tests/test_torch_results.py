"""``Results.summary()`` of the port against the JAX package's on the same
arrays: the JSON rows the servers answer with (2D ``box``; 3D ``box3d``
with xyz, hwl, ry and depth_sigma). Keys and values must be equal."""

import json

import numpy as np
import pytest

from yolov10_3d_tpu.engine.results import Results as JaxResults
from yolov10_3d_torch.engine.results import Results

NAMES = {0: "Car", 1: "Pedestrian", 2: "Cyclist"}


def _rows(rng, n, cols):
    d = rng.normal(0, 50, (n, cols)).astype(np.float32)
    d[:, 2:4] = d[:, :2] + np.abs(d[:, 2:4])
    d[:, 4] = rng.uniform(0, 1, n)
    d[:, 5] = rng.integers(0, 4, n)  # class 3 has no name: "3"
    return d


@pytest.mark.parametrize("kind,n", [("2d", 0), ("2d", 7), ("3d", 0), ("3d", 5)])
def test_summary_matches_jax(kind, n):
    rng = np.random.default_rng(n + len(kind))
    img = np.zeros((48, 64, 3), np.uint8)
    boxes = _rows(rng, n, 6)
    boxes3d = None
    if kind == "3d":
        boxes3d = np.concatenate([boxes, rng.normal(0, 5, (n, 10)).astype(np.float32)], 1)
    want = JaxResults(img, names=NAMES, boxes=boxes, boxes3d=boxes3d).summary()
    got = Results(img, names=NAMES, boxes=boxes, boxes3d=boxes3d).summary()
    assert len(got) == n
    assert got == want
    assert json.loads(json.dumps(got)) == got  # JSON-ready, exact round trip
    if n and kind == "3d":
        assert set(got[0]["box3d"]) == {"xyz", "hwl", "ry", "depth_sigma"}


def test_summary_without_boxes_is_empty():
    img = np.zeros((4, 4, 3), np.uint8)
    assert Results(img).summary() == JaxResults(img).summary() == []
