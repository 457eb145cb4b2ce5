"""Inference sources beside files (port of ``yolov10_3d_tpu/data/loaders.py``).

``is_stream_source`` tells the live sources apart, and ``LoadTensor`` turns
a numpy or torch tensor into frames. The JAX module's threaded webcam, RTSP
and video reader (``LoadStreams``) and its screen grabber
(``LoadScreenshots``) read through cv2 and a screen library, which the port
does not depend on: they raise ``NotImplementedError`` naming ROADMAP item 22,
as video files do in ``engine/predictor.py`` ``load_source``.
"""

from __future__ import annotations

import re

import numpy as np

STREAM_PREFIXES = ("rtsp://", "rtmp://", "http://", "https://", "tcp://")
UNPORTED = "ROADMAP queue 1, item 22 (video and live sources)"


def is_stream_source(source) -> bool:
    """webcam index, 'N' digit string, *.streams list file, or a URL."""
    if isinstance(source, int):
        return True
    if isinstance(source, str):
        s = source.strip().lower()
        return s.isdigit() or s.startswith(STREAM_PREFIXES) or s.endswith(".streams")
    return False


def is_endless(source) -> bool:
    """A live stream or a screen: the sources the JAX facade streams even
    without ``stream=True``."""
    return is_stream_source(source) or bool(
        isinstance(source, str) and re.fullmatch(r"screen\d*", source))


class LoadStreams:
    """Webcams, RTSP/HTTP streams and ``.streams`` lists: not ported."""

    def __init__(self, sources, vid_stride: int = 1, buffer: bool = False, max_buffer: int = 30):
        raise NotImplementedError(f"stream source {sources!r}: {UNPORTED}")


class LoadScreenshots:
    """Screen capture (``screen`` / ``screenN``): not ported."""

    def __init__(self, source: str = "screen"):
        raise NotImplementedError(f"screen source {source!r}: {UNPORTED}")


class LoadTensor:
    """Pre-made tensor source: numpy or torch, HWC or BHWC (RGB) or BCHW,
    uint8 or float in [0, 1] (floats become ``(x * 255)`` truncated to
    uint8, one channel repeated to three), as the JAX ``LoadTensor``."""

    def __init__(self, tensor):
        if hasattr(tensor, "detach"):  # torch
            tensor = tensor.detach().cpu().numpy()
        arr = np.asarray(tensor)
        if arr.ndim == 3:
            arr = arr[None]
        if arr.ndim != 4:
            raise ValueError(f"tensor source must be 3D/4D, got shape {arr.shape}")
        if arr.shape[1] in (1, 3) and arr.shape[-1] not in (1, 3):  # BCHW -> BHWC
            arr = arr.transpose(0, 2, 3, 1)
        if arr.dtype != np.uint8:
            if arr.max() > 1.001:
                raise ValueError(
                    "float tensor source must be normalized to [0,1] "
                    f"(max={float(arr.max()):.3f})"
                )
            arr = (arr * 255).astype(np.uint8)
        if arr.shape[-1] == 1:
            arr = np.repeat(arr, 3, -1)
        self.arr = arr

    def __iter__(self):
        for i, im in enumerate(self.arr):
            yield f"tensor{i}", im
