"""Video files for the port's video and tracking tests: Motion-JPEG AVI
clips written by cv2 (FFmpeg's muxer), their payloads read back by a walk
of the RIFF chunks written here (independent of the port's reader), a
muxer for clips of given JPEG payloads, and a ``cv2.VideoCapture``
stand-in that hands the JAX package the port's frames, so that everything
after the decode is compared on the same pixels."""

from __future__ import annotations

import struct
from pathlib import Path

import cv2
import numpy as np

from yolov10_3d_torch.data.video import VideoReader


def write_clip(path: Path, frames, fps: int = 30, fourcc: str = "MJPG") -> Path:
    """``cv2.VideoWriter`` of RGB ``frames``."""
    h, w = frames[0].shape[:2]
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    assert out.isOpened(), fourcc
    for f in frames:
        out.write(np.ascontiguousarray(f[..., ::-1]))
    out.release()
    return path


def moving_frames(rng, n: int, h: int, w: int, noisy: bool = False, pan: int = 0,
                  cell: int = 32):
    """A smooth background (coarse noise, one value per ``cell`` pixels,
    upsampled by cv2) panned ``pan`` px a frame, with two boxes moving
    across it; ``noisy`` adds per-pixel noise."""
    bw = w + pan * n
    bg = cv2.resize(rng.integers(0, 256, (h // cell, bw // cell, 3), dtype=np.uint8), (bw, h))
    out = []
    for t in range(n):
        f = bg[:, pan * t:pan * t + w].copy()
        f[40 + 2 * t:140 + 2 * t, 60 + 9 * t:200 + 9 * t] = (230, 40, 40)
        f[h - 200:h - 60, w - 180 - 7 * t:w - 80 - 7 * t] = (30, 200, 60)
        if noisy:
            f = np.clip(f + rng.normal(0, 25, f.shape), 0, 255).astype(np.uint8)
        out.append(f)
    return out


def chunks(data: bytes, start: int, end: int):
    """(fourcc, payload offset, size) of the RIFF chunks in [start, end)."""
    off = start
    while off + 8 <= end:
        cid, size = struct.unpack("<4sI", data[off:off + 8])
        yield cid, off + 8, size
        off += 8 + size + (size & 1)


def payloads(path: Path):
    """The ``00dc`` payloads of the first RIFF's ``LIST movi``."""
    data = Path(path).read_bytes()
    for cid, off, size in chunks(data, 12, len(data)):
        if cid == b"LIST" and data[off:off + 4] == b"movi":
            return [data[o:o + s] for c, o, s in chunks(data, off + 4, off + size) if c == b"00dc"]
    raise AssertionError("no movi list")


def mux(path: Path, jpegs, w: int, h: int, fps: int = 30) -> Path:
    """A Motion-JPEG AVI of the given payloads (hdrl, movi, no index)."""
    def chunk(cid, body):
        return cid + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)

    avih = struct.pack("<10I16x", 1_000_000 // fps, 0, 0, 0, len(jpegs), 0, 1, 0, w, h)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", b"MJPG", 0, 0, 0, 0, 1, fps, 0,
                       len(jpegs), 0, 0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0)
    hdrl = b"hdrl" + chunk(b"avih", avih) + chunk(b"LIST", b"strl" + chunk(b"strh", strh)
                                                  + chunk(b"strf", strf))
    movi = b"movi" + b"".join(chunk(b"00dc", j) for j in jpegs)
    body = b"AVI " + chunk(b"LIST", hdrl) + chunk(b"LIST", movi)
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
    return path


def strip_dht(jpeg: bytes) -> bytes:
    """The JPEG without its DHT segments (the scan uses the standard tables)."""
    out, p = bytearray(jpeg[:2]), 2
    while True:
        marker, length = jpeg[p + 1], struct.unpack(">H", jpeg[p + 2:p + 4])[0]
        if marker == 0xDA:
            return bytes(out + jpeg[p:])
        if marker != 0xC4:
            out += jpeg[p:p + 2 + length]
        p += 2 + length


class PortCapture:
    """``cv2.VideoCapture(path)`` reading the port's frames (BGR, as cv2
    hands them over); opens nothing for a missing file, as cv2 does."""

    def __init__(self, path, *a):
        self.frames = list(VideoReader(path)) if Path(str(path)).is_file() else []
        self.i = 0

    def isOpened(self):
        return bool(self.frames) and self.i <= len(self.frames)

    def read(self):
        ok, f = self.grab(), None
        if ok:
            f = self.retrieve()[1]
        return ok, f

    def grab(self):
        self.i += 1
        return self.i <= len(self.frames)

    def retrieve(self):
        return True, np.ascontiguousarray(self.frames[self.i - 1][..., ::-1])

    def get(self, prop):
        return 30.0 if prop == cv2.CAP_PROP_FPS else 0.0

    def release(self):
        self.frames = []
