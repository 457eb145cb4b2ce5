"""Video files without cv2: Motion-JPEG in AVI (ROADMAP item 22a).

The JAX package reads video through ``cv2.VideoCapture`` (FFmpeg). The port
reads the one format it can decode with code of its own: a RIFF AVI whose
video stream is Motion-JPEG (``MJPG`` in any case), each frame a JPEG file
decoded by ``data/image_io.py``'s cv2 rule (``native/image_codec.cc``, the
pixels of ``cv2.imdecode`` of the frame's bytes).

The reader walks every ``LIST movi`` in file order, the first RIFF's and
those of the OpenDML ``AVIX`` extensions FFmpeg writes past 1 GiB, and
yields the video stream's ``##dc``/``##db`` chunks, descending into
``LIST rec``; ``JUNK``, index (``idx1``, ``ix##``) and other streams'
chunks are passed over, odd-sized chunks take their pad byte. A frame
chunk of zero bytes is skipped, as FFmpeg skips it: the frames after it
keep consecutive indices. ``fps`` is the video stream header's
``dwRate / dwScale`` (``avih``'s frame period when that is unset).
Iterating decodes on ``DECODE_THREADS`` threads, up to twice as many
frames ahead of the consumer (the codec releases the interpreter lock),
and yields the frames in file order.

FFmpeg decodes JPEG with its own inverse DCT and colour conversion, so its
frames differ from the payloads' libjpeg pixels by about a level on
average (at most a few dozen at colour edges; ROADMAP queue 3). Any other
container (MP4, MOV, MKV, WebM) or codec raises ``NotImplementedError``
naming ROADMAP item 22b.
"""

from __future__ import annotations

import os
import struct
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, List, Tuple, Union

import numpy as np

from .image_io import decode_bytes

UNPORTED_CODEC = "ROADMAP queue 1, item 22b (video codecs other than Motion-JPEG in AVI)"
MJPEG = b"MJPG"
DECODE_THREADS = min(4, os.cpu_count() or 1)


class VideoReader:
    """The frames of a Motion-JPEG AVI file: ``fps``, ``frames`` (the count
    it yields), ``width``, ``height``; iterating yields HWC RGB uint8 frames,
    ``payloads()`` the JPEG bytes."""

    def __init__(self, path: Union[str, Path]):
        self.path = str(path)
        self._f = open(self.path, "rb")
        try:
            self._size = self._f.seek(0, 2)
            self.fps, self.width, self.height = 0.0, 0, 0
            self._stream = None  # the video stream's index, from its strl's position
            self._period_us = 0
            self._chunks: List[Tuple[int, int]] = []  # (offset, size) of each frame's payload
            self._parse()
        except BaseException:
            self._f.close()
            raise
        self.frames = len(self._chunks)

    # -- RIFF ---------------------------------------------------------------
    def _read(self, off: int, n: int) -> bytes:
        self._f.seek(off)
        return self._f.read(n)

    def _children(self, start: int, end: int) -> Iterator[Tuple[bytes, int, int]]:
        """(fourcc, payload offset, payload size) of the chunks in
        [start, end), a chunk that runs past the file cut at its end."""
        off = start
        while off + 8 <= end:
            cid, size = struct.unpack("<4sI", self._read(off, 8))
            size = min(size, end - off - 8)
            yield cid, off + 8, size
            off += 8 + size + (size & 1)

    def _parse(self) -> None:
        head = self._read(0, 12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"AVI ":
            raise NotImplementedError(f"{self.path}: not an AVI file ({UNPORTED_CODEC})")
        movi = []
        for cid, off, size in self._children(0, self._size):
            if cid != b"RIFF":
                continue
            form = self._read(off, 4)
            if form not in (b"AVI ", b"AVIX"):
                continue
            for sub, soff, ssize in self._children(off + 4, off + size):
                if sub != b"LIST":
                    continue
                kind = self._read(soff, 4)
                if kind == b"hdrl":
                    self._header(soff + 4, soff + ssize)
                elif kind == b"movi":
                    movi.append((soff + 4, soff + ssize))
        if self._stream is None:
            raise NotImplementedError(f"{self.path}: an AVI without a video stream "
                                      f"({UNPORTED_CODEC})")
        if not self.fps and self._period_us:
            self.fps = 1e6 / self._period_us
        ids = (b"%02ddc" % self._stream, b"%02ddb" % self._stream)
        for start, end in movi:
            self._index(start, end, ids)

    def _header(self, start: int, end: int) -> None:
        streams = 0
        for cid, off, size in self._children(start, end):
            if cid == b"avih" and size >= 4:
                self._period_us = struct.unpack("<I", self._read(off, 4))[0]
            elif cid == b"LIST" and self._read(off, 4) == b"strl":
                self._stream_header(streams, off + 4, off + size)
                streams += 1

    def _stream_header(self, index: int, start: int, end: int) -> None:
        kind = handler = compression = None
        rate = scale = 0
        wh = (0, 0)
        for cid, off, size in self._children(start, end):
            if cid == b"strh" and size >= 28:
                kind, handler, scale, rate = struct.unpack("<4s4s12xII", self._read(off, 28))
            elif cid == b"strf" and size >= 20:
                w, h, _, _, compression = struct.unpack("<iiHH4s", self._read(off + 4, 16))
                wh = (abs(w), abs(h))
        if kind != b"vids" or self._stream is not None:
            return
        codec = compression if compression not in (None, b"\0\0\0\0") else handler
        if codec is None or codec.upper() != MJPEG:
            raise NotImplementedError(f"{self.path}: AVI video coded as {codec!r}, not "
                                      f"Motion-JPEG ({UNPORTED_CODEC})")
        self._stream = index
        self.width, self.height = wh
        self.fps = rate / scale if rate and scale else 0.0

    def _index(self, start: int, end: int, ids) -> None:
        for cid, off, size in self._children(start, end):
            if cid == b"LIST" and self._read(off, 4) == b"rec ":
                self._index(off + 4, off + size, ids)
            elif cid in ids and size > 0:
                self._chunks.append((off, size))

    # -- frames -------------------------------------------------------------
    def payloads(self) -> Iterator[bytes]:
        """Each frame's JPEG bytes, in file order."""
        for off, size in self._chunks:
            yield self._read(off, size)

    def __iter__(self) -> Iterator[np.ndarray]:
        with ThreadPoolExecutor(DECODE_THREADS) as pool:
            ahead: deque = deque()
            for i, data in enumerate(self.payloads()):
                ahead.append(pool.submit(decode_bytes, data, "cv2", f"{self.path}#{i}"))
                if len(ahead) > 2 * DECODE_THREADS:
                    yield ahead.popleft().result()
            while ahead:
                yield ahead.popleft().result()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
