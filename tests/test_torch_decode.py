"""The NMS-free decode (K1's plain twin) and the top-k postprocess of the
PyTorch port against the JAX package. K1 itself is held against the twin on
the card by tests/test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from yolov10_3d_tpu.ops.boxes import make_anchors as jax_make_anchors
from yolov10_3d_tpu.ops.pallas_kernels import decode_detect_pallas
from yolov10_3d_tpu.ops import postprocess as JP
from yolov10_3d_torch.kernels import launch_counts
from yolov10_3d_torch.ops import postprocess as TP
from yolov10_3d_torch.ops.boxes import make_anchors

NC, REG_MAX = 80, 16
SHAPES = [(8, 8), (4, 4), (2, 2)]  # the inputs of tests/test_pallas_kernels.py
STRIDES = (8, 16, 32)


def _feats(seed=0, B=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (B, h, w, 4 * REG_MAX + NC)).astype(np.float32)
            for h, w in SHAPES]


def _nchw(feats):
    return [torch.from_numpy(f.transpose(0, 3, 1, 2).copy()) for f in feats]


def test_make_anchors_matches_jax():
    a, s = make_anchors(SHAPES, STRIDES)
    ja, js = jax_make_anchors(SHAPES, STRIDES)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_decode_twin_matches_jax_and_pallas():
    """The twin against the XLA decode and the TPU kernel in interpret mode,
    at the bar of tests/test_pallas_kernels.py (rtol 1e-5; atol 1e-5 on boxes,
    1e-6 on scores): float32 on both sides, exp and sums round differently."""
    feats = _feats()
    want = np.asarray(JP.decode_detect([jnp.asarray(f) for f in feats], STRIDES, NC))
    flat = jnp.concatenate([jnp.asarray(f).reshape(2, -1, f.shape[-1]) for f in feats], 1)
    anchors, stride_t = jax_make_anchors(SHAPES, STRIDES, 0.5)
    boxes, scores = decode_detect_pallas(flat, anchors, stride_t, NC, block_a=28,
                                         interpret=True)
    pallas = np.concatenate([np.asarray(boxes), np.asarray(scores)], -1)

    before = launch_counts["decode_detect"]
    got = TP.decode_detect(_nchw(feats), STRIDES, NC).numpy()
    assert launch_counts["decode_detect"] == before  # CPU tensors: the twin, no kernel
    assert got.shape == (2, 84, 4 + NC)
    for ref in (want, pallas):
        np.testing.assert_allclose(got[..., :4], ref[..., :4], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[..., 4:], ref[..., 4:], rtol=1e-5, atol=1e-6)


def test_flatten_feats_anchor_order():
    """NCHW flatten(2) gives the JAX anchor order: per scale, H x W row-major."""
    feats = _feats()
    want, wshapes = JP.flatten_feats([jnp.asarray(f) for f in feats])
    got, shapes = TP.flatten_feats(_nchw(feats))
    assert shapes == wshapes
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("A,nc,max_det", [(84, 80, 300), (84, 80, 20), (3, 2, 10)])
def test_v10_postprocess_equals_jax(A, nc, max_det):
    """Same decoded array in, identical top-k out (ties have probability 0
    for continuous inputs); the last case pads to max_det."""
    rng = np.random.default_rng(A + nc + max_det)
    preds = np.concatenate(
        [rng.uniform(0, 64, (2, A, 4)), rng.uniform(0, 1, (2, A, nc))], -1
    ).astype(np.float32)
    want = JP.v10_postprocess(jnp.asarray(preds), max_det, nc)
    got = TP.v10_postprocess(torch.from_numpy(preds), max_det, nc)
    for w, g in zip(want, got):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_v10_detections_matches_jax():
    feats = _feats(seed=3)
    want = JP.v10_detections([jnp.asarray(f) for f in feats], STRIDES, NC, max_det=50, conf=0.5)
    got = TP.v10_detections(_nchw(feats), STRIDES, NC, max_det=50, conf=0.5)
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]),
                               rtol=1e-5, atol=1e-5)
