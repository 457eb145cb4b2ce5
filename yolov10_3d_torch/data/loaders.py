"""Inference sources beside files (port of ``yolov10_3d_tpu/data/loaders.py``).

``is_stream_source`` tells the stream sources apart, ``LoadStreams`` reads
video files (and ``.streams`` lists of them) on threads, and ``LoadTensor``
turns a numpy or torch tensor into frames. The JAX ``LoadStreams`` reads
through ``cv2.VideoCapture``; the port's reads Motion-JPEG AVI files with
``data/video.py`` (item 22a; other codecs raise naming 22b). Webcams,
``rtsp://``, ``rtmp://``, ``http(s)://`` and ``tcp://`` streams and the
screen grabber (``LoadScreenshots``) raise ``NotImplementedError`` naming
ROADMAP item 22c (live sources).
"""

from __future__ import annotations

import re
import threading
import time
from pathlib import Path
from typing import Iterator, List, Sequence, Tuple, Union

import numpy as np

from .image_io import decode_bytes
from .video import VideoReader

STREAM_PREFIXES = ("rtsp://", "rtmp://", "http://", "https://", "tcp://")
UNPORTED = "ROADMAP queue 1, item 22c (live sources: webcams, network streams, screens)"


def is_stream_source(source) -> bool:
    """webcam index, 'N' digit string, *.streams list file, or a URL."""
    if isinstance(source, int):
        return True
    if isinstance(source, str):
        s = source.strip().lower()
        return s.isdigit() or s.startswith(STREAM_PREFIXES) or s.endswith(".streams")
    return False


def is_endless(source) -> bool:
    """A stream source or a screen: the sources the JAX facade streams even
    without ``stream=True``."""
    return is_stream_source(source) or bool(
        isinstance(source, str) and re.fullmatch(r"screen\d*", source))


def stream_sources(sources: Union[str, int, Path, Sequence]) -> List[str]:
    """The sources a ``LoadStreams`` reads: a ``.streams`` file's lines, a
    list, or one source. A webcam index or a network URL raises naming item
    22c."""
    if isinstance(sources, (str, Path)) and str(sources).endswith(".streams"):
        sources = [s.strip() for s in Path(sources).read_text().splitlines() if s.strip()]
    elif not isinstance(sources, (list, tuple)):
        sources = [sources]
    out = [str(s) for s in sources]
    for s in out:
        if s.isdigit() or s.lower().startswith(STREAM_PREFIXES):
            raise NotImplementedError(f"stream source {s!r}: {UNPORTED}")
    return out


class LoadStreams:
    """Threaded multi-stream frame reader over video files (the JAX
    ``LoadStreams``, loaders.py:33-183).

    Each source gets a daemon reader thread, which reads every frame's bytes
    and decodes every ``vid_stride``-th (the 2nd, 4th, ... at stride 2).
    ``buffer=True`` keeps every frame: the reader blocks while
    ``max_buffer`` frames wait. ``buffer=False`` keeps only the latest
    frame, the reader pausing a frame period (``1 / fps``) while one waits,
    so frames are dropped as a live camera drops them. A reader appends
    ``None`` at its end. Iteration yields ``(paths, frames)``, one entry per
    source with a frame this round (the path is the source's, RGB uint8);
    a source whose reader has no frame for 5 s is skipped that round, and
    ended once its thread has stopped. A file that does not open raises
    ``ConnectionError`` as in JAX; ``close()`` stops and joins the threads.
    """

    def __init__(
        self,
        sources: Union[str, int, Sequence],
        vid_stride: int = 1,
        buffer: bool = False,
        max_buffer: int = 30,
    ):
        self.buffer = buffer
        self.max_buffer = max_buffer
        self.vid_stride = vid_stride
        self.running = True
        self.sources = stream_sources(sources)
        n = len(self.sources)
        self.readers: List = [None] * n
        self.frames: List[List[np.ndarray]] = [[] for _ in range(n)]
        self.locks = [threading.Lock() for _ in range(n)]
        self.fps = [0.0] * n
        self.threads: List[threading.Thread] = []
        try:
            for i, s in enumerate(self.sources):
                if not Path(s).is_file():
                    raise ConnectionError(f"failed to open stream {s!r}")
                self.readers[i] = VideoReader(s)
                self.fps[i] = max(self.readers[i].fps or 0, 0) or 30.0
        except BaseException:
            self.close()
            raise
        for i in range(n):
            t = threading.Thread(target=self._reader, args=(i,), daemon=True)
            t.start()
            self.threads.append(t)

    def _reader(self, i: int):
        reader = self.readers[i]
        n = 0
        try:
            for data in reader.payloads():
                if not self.running:
                    break
                if not self.buffer and len(self.frames[i]) >= 1:
                    time.sleep(1 / max(self.fps[i], 1))  # latest-frame mode
                n += 1
                if n % self.vid_stride:
                    continue
                im = decode_bytes(data, "cv2", f"{reader.path}#{n - 1}")
                if self.buffer:  # keep every frame: wait for the consumer
                    while self.running:
                        with self.locks[i]:
                            if len(self.frames[i]) < self.max_buffer:
                                self.frames[i].append(im)
                                break
                        time.sleep(0.005)
                else:
                    with self.locks[i]:
                        self.frames[i] = [im]
        finally:
            with self.locks[i]:
                self.frames[i].append(None)  # end-of-stream sentinel

    def __iter__(self) -> Iterator[Tuple[List[str], List[np.ndarray]]]:
        ended = [False] * len(self.sources)
        while self.running and not all(ended):
            paths, imgs = [], []
            for i in range(len(self.sources)):
                if ended[i]:
                    continue
                frame = None
                popped = False
                for _ in range(1000):  # wait up to ~5 s for a frame
                    with self.locks[i]:
                        if self.frames[i]:
                            frame = self.frames[i].pop(0)
                            popped = True
                            break
                    if not self.threads[i].is_alive():
                        break
                    time.sleep(0.005)
                if popped and frame is None:  # the reader's end-of-stream sentinel
                    ended[i] = True
                    continue
                if frame is None:
                    if not self.threads[i].is_alive():
                        ended[i] = True  # the reader stopped without its sentinel
                    continue  # a stall: try again next round
                paths.append(self.sources[i])
                imgs.append(frame)
            if imgs:
                yield paths, imgs
        self.close()

    def __len__(self):
        return len(self.sources)

    def close(self):
        """Stop the readers, join their threads and close the files."""
        self.running = False
        for t in self.threads:
            if t.is_alive():
                t.join(timeout=1.0)
        for r in self.readers:
            if r is not None:
                r.close()


class LoadScreenshots:
    """Screen capture (``screen`` / ``screenN``): not ported (item 22c)."""

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
