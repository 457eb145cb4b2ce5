"""Serving preprocess of the PyTorch port against the JAX package: letterbox
geometry, the numpy host resize (cv2 INTER_LINEAR in the JAX package, equal
bit for bit on downscales and upscales) and the device letterbox
(jax.image.resize bilinear, antialiased on downscale)."""

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
    """The numpy resize is cv2's fixed-point INTER_LINEAR: the letterbox
    equals JAX's bit for bit on every source, the upscales included."""
    img = np.random.default_rng(sum(hw)).integers(0, 256, (*hw, 3), dtype=np.uint8)
    got, r, pad = TD.letterbox(img, (128, 128))
    want, wr, wpad = JD.letterbox(img, (128, 128))
    assert (r, pad) == (wr, wpad)
    np.testing.assert_array_equal(got, want)


def test_resize_linear_matches_cv2_exactly_on_downscale():
    img = np.random.default_rng(0).integers(0, 256, (375, 1242, 3), dtype=np.uint8)
    for size in ((640, 193), (320, 97), (128, 39)):
        np.testing.assert_array_equal(
            TD.resize_linear(img, size), cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)
        )


# (source h, w) -> (w, h): upscales both ways, one axis up and one down, and
# a one-row or one-column source
UPSCALES = [((48, 64), (85, 64)), ((100, 100), (128, 128)), ((33, 47), (128, 92)),
            ((50, 70), (128, 91)), ((64, 8), (8, 85)), ((120, 40), (90, 200)), ((1, 7), (9, 5)),
            ((7, 1), (4, 13))]


@pytest.mark.parametrize("hw,size", UPSCALES)
def test_resize_linear_matches_cv2_exactly_on_upscale(hw, size):
    """A row mapped above the source's first (or below its last) keeps its
    fractional weights on the edge row taken twice, which cv2 rounds in two
    products: the columns clamp to weight 1, the rows do not."""
    img = np.random.default_rng(sum(hw)).integers(0, 256, (*hw, 3), dtype=np.uint8)
    np.testing.assert_array_equal(TD.resize_linear(img, size),
                                  cv2.resize(img, size, interpolation=cv2.INTER_LINEAR))


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
