"""Serving preprocess of the PyTorch port against the JAX package: letterbox
geometry, the numpy host resize (cv2 INTER_LINEAR in the JAX package) and the
device letterbox (jax.image.resize bilinear, antialiased on downscale)."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_threads  # noqa: F401  (autouse)
from yolov10_3d_tpu.data import preprocess as JD
from yolov10_3d_tpu.ops import pallas_preprocess as JPP
from yolov10_3d_torch.data import preprocess as TD
from yolov10_3d_torch.ops.preprocess import device_letterbox, serve_preprocess

# (h, w) sources for a 128x128 target: downscale, upscale, no resize, odd sizes
SOURCES = [(96, 160), (375, 1242), (50, 70), (128, 96), (80, 128), (33, 47)]


@pytest.mark.parametrize("hw", SOURCES)
def test_letterbox_geometry_matches_jax(hw):
    for new in (128, (128, 96), (640, 640)):
        assert TD.letterbox_geometry(hw, new) == JD.letterbox_geometry(hw, new)


@pytest.mark.parametrize("hw", SOURCES)
def test_host_letterbox_matches_jax(hw):
    """The numpy resize reproduces cv2's fixed-point INTER_LINEAR: at most one
    grey level apart (measured: equal on downscales; 0.2% of the pixels one
    level off on the two upscales); pure padding is exact."""
    img = np.random.default_rng(sum(hw)).integers(0, 256, (*hw, 3), dtype=np.uint8)
    got, r, pad = TD.letterbox(img, (128, 128))
    want, wr, wpad = JD.letterbox(img, (128, 128))
    assert (r, pad) == (wr, wpad)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    if min(128 / hw[0], 128 / hw[1]) <= 1:  # downscale or no resize
        assert diff.max() == 0


def test_resize_linear_matches_cv2_exactly_on_downscale():
    img = np.random.default_rng(0).integers(0, 256, (375, 1242, 3), dtype=np.uint8)
    for size in ((640, 193), (320, 97), (128, 39)):
        np.testing.assert_array_equal(
            TD.resize_linear(img, size), cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)
        )


def test_preprocess_batch_matches_jax():
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for hw in [(128, 96), (80, 128)]]
    got, shapes = TD.preprocess_batch(imgs, 128)
    want, wshapes = JD.preprocess_batch(imgs, 128)
    assert shapes == wshapes
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", SOURCES)
def test_serve_preprocess_matches_jax(hw):
    """Device letterbox: torch's antialiased bilinear computes the same
    triangle weights as jax.image.resize. Bar 1e-6 on [0, 1] pixels (float32
    rounding of the weights; measured max 3.0e-7)."""
    imgs = np.random.default_rng(sum(hw)).integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    want = np.asarray(JPP.serve_preprocess(jnp.asarray(imgs), (128, 128)))
    got = serve_preprocess(torch.from_numpy(imgs), (128, 128))
    assert got.shape == (2, 3, 128, 128)
    err = np.abs(got.numpy().transpose(0, 2, 3, 1) - want).max()
    assert err <= 1e-6, err


def test_device_letterbox_non_square_target():
    x = np.random.default_rng(2).uniform(0, 1, (1, 90, 200, 3)).astype(np.float32)
    want = np.asarray(JPP.device_letterbox(jnp.asarray(x), (96, 160)))
    got = device_letterbox(torch.from_numpy(x), (96, 160)).numpy().transpose(0, 2, 3, 1)
    assert np.abs(got - want).max() <= 1e-6
