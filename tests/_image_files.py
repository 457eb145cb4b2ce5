"""Image files written byte by byte for the codec tests: PNG at any bit
depth and colour type, with any row filter and Adam7 interlace; BMP in
each uncompressed layout; an EXIF orientation spliced into a JPEG. cv2 and
PIL write only some of these, so the tests write them here and hold the
port's decoder to what cv2 and PIL read back."""

from __future__ import annotations

import struct
import zlib

import numpy as np

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(tag: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))


def _pack_rows(s: np.ndarray, depth: int) -> np.ndarray:
    h = s.shape[0]
    if depth == 16:
        return s.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return s.astype(np.uint8)
    per = 8 // depth
    s = np.concatenate([s, np.zeros((h, (-s.shape[1]) % per), s.dtype)], 1).reshape(h, -1, per)
    out = np.zeros(s.shape[:2], np.int64)
    for i in range(per):
        out |= s[:, :, i].astype(np.int64) << (8 - depth * (i + 1))
    return out.astype(np.uint8)


def _filter(rows: np.ndarray, bpp: int, ft: int, rng) -> bytes:
    out, prior = [], np.zeros(rows.shape[1], np.int64)
    for row in rows.astype(np.int64):
        f = ft if ft >= 0 else int(rng.integers(0, 5))
        a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        b = prior
        if f == 0:
            r = row
        elif f == 1:
            r = row - a
        elif f == 2:
            r = row - b
        elif f == 3:
            r = row - ((a + b) >> 1)
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            r = row - np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        out.append(bytes([f]) + (r & 255).astype(np.uint8).tobytes())
        prior = row
    return b"".join(out)


def png(samples: np.ndarray, depth: int, ctype: int, palette=None, trns=None,
        interlace: bool = False, ft: int = -1, seed: int = 0, exif_orientation=None) -> bytes:
    """A PNG of (h, w, channels) integer samples; ``ft`` -1 draws each row's
    filter from ``seed``."""
    rng = np.random.default_rng(seed)
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    if not interlace:
        data = _filter(_pack_rows(samples.reshape(h, w * ch), depth), bpp, ft, rng)
    else:
        data = b""
        for x0, y0, dx, dy in ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                data += _filter(_pack_rows(sub.reshape(sub.shape[0], -1), depth), bpp, ft, rng)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                                              0, int(interlace)))
    if exif_orientation is not None:
        out += _chunk(b"eXIf", tiff_orientation(exif_orientation))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b"")


def bmp(pixels: np.ndarray, bits: int, palette=None, top_down: bool = False,
        core: bool = False) -> bytes:
    """An uncompressed BMP: ``pixels`` HWC RGB for 24/32 bits, else (h, w)
    palette indices; ``core`` writes the 12-byte BITMAPCOREHEADER."""
    h, w = pixels.shape[:2]
    stride = (w * bits + 31) // 32 * 4
    rows = np.zeros((h, stride), np.uint8)
    if bits >= 24:
        px = pixels[..., ::-1]
        if bits == 32:
            px = np.concatenate([px, np.full((h, w, 1), 7, np.uint8)], 2)
        rows[:, :w * bits // 8] = px.reshape(h, -1)
    else:
        packed = _pack_rows(pixels.astype(np.int64), bits)
        rows[:, :packed.shape[1]] = packed
    if not top_down:
        rows = rows[::-1]
    pal = b"" if palette is None else b"".join(
        bytes([b, g, r]) + (b"" if core else b"\x00") for r, g, b in np.asarray(palette))
    if core:
        dib = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        dib = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bits, 0, rows.size,
                          2835, 2835, 0 if palette is None else len(palette), 0)
    off = 14 + len(dib) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + rows.size, 0, 0, off) + dib + pal + rows.tobytes()


def tiff_orientation(o: int, endian: str = "II") -> bytes:
    e = "<" if endian == "II" else ">"
    return (endian.encode() + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x112, 3, 1, o, 0) + struct.pack(e + "I", 0))


def with_exif(jpeg: bytes, o: int, endian: str = "II") -> bytes:
    """``jpeg`` with an APP1 EXIF segment holding orientation ``o``."""
    tiff = tiff_orientation(o, endian)
    return jpeg[:2] + b"\xff\xe1" + struct.pack(">H", 8 + len(tiff)) + b"Exif\x00\x00" + tiff + jpeg[2:]


def smooth(h: int, w: int, seed: int) -> np.ndarray:
    """A seeded HWC uint8 image: coarse noise upsampled, plus fine noise
    (what a JPEG of a photograph codes: both flat and busy blocks)."""
    r = np.random.default_rng(seed)
    base = r.integers(0, 256, (h // 4 + 2, w // 4 + 2, 3)).astype(np.float64)
    ys, xs = np.linspace(0, base.shape[0] - 1.001, h), np.linspace(0, base.shape[1] - 1.001, w)
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    img = (base[y0][:, x0] * (1 - fy) * (1 - fx) + base[y0 + 1][:, x0] * fy * (1 - fx)
           + base[y0][:, x0 + 1] * (1 - fy) * fx + base[y0 + 1][:, x0 + 1] * fy * fx)
    return np.clip(img + r.integers(-20, 21, (h, w, 3)), 0, 255).astype(np.uint8)
