"""Image files without cv2 or PIL: JPEG, PNG and BMP decoding, JPEG encoding
(ROADMAP item 9f).

``decode_bytes(data, rule)`` and ``imread(path, rule)`` give HWC RGB uint8
pixels equal to one of the two libraries the JAX package reads with:

- ``rule="cv2"``: ``cv2.imread(path)`` then ``COLOR_BGR2RGB`` (cv2 5.0). A
  JPEG's EXIF orientation is applied; 16-bit PNG samples keep their high
  byte. The JAX package reads this way where it reads files and datasets
  (``engine/predictor.py`` ``load_source``, ``data/dataset.py``).
- ``rule="pil"``: ``Image.open(...).convert("RGB")`` (Pillow 12). No EXIF
  orientation; a 16-bit grey PNG is clipped to 255. The JAX package reads
  this way in its server (``engine/server.py``) and its KITTI dataset.

Both libraries decode JPEG with libjpeg-turbo at its defaults, so the JPEG
pixels are the same under either rule; the port's decoder is
``native/image_codec.cc`` (its stages in numpy: ``data/codec_rules.py``).
PNG is parsed here (zlib for the data, the library for the unfilter, numpy
for bit depths 1-16, palettes and Adam7); BMP (1/4/8-bit palette, 24- and
32-bit, bottom-up or top-down, uncompressed) is numpy only. The format is
told by the file's first bytes, as both libraries tell it. TIFF and WebP
raise ``NotImplementedError`` naming ROADMAP item 21.

Each rule refuses, with ``ValueError`` and before it allocates for the
pixels, the image sizes its library refuses: under cv2's rule more than
2**30 pixels or a side over 2**20 (``CV_IO_MAX_IMAGE_PIXELS`` and
``CV_IO_MAX_IMAGE_WIDTH``/``HEIGHT`` at their defaults), under PIL's more
than ``2 * Image.MAX_IMAGE_PIXELS`` (Pillow's ``DecompressionBombError``).
PNG data is inflated no further than the image's own rows.

``encode_jpeg(img, style)`` writes the bytes of ``PIL.Image.save(f,
"JPEG")`` at its defaults (``style="pil"``, quality 75) or of
``cv2.imencode(".jpg")`` (``style="cv2"``, quality 95): both are
libjpeg-turbo's baseline 4:2:0 files with a JFIF 1.01 header.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Union

import numpy as np

from ..native import image_codec

IMG_FORMATS = {"bmp", "jpeg", "jpg", "png", "tif", "tiff", "webp"}
RULES = ("cv2", "pil")
JPEG_QUALITY = {"pil": 75, "cv2": 95}  # each library's default quality
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # grey, RGB, palette, grey + alpha, RGBA
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))  # (x0, y0, dx, dy) of each pass
_UNPORTED = "ROADMAP queue 1, item 21"
MAX_PIXELS = {"cv2": 1 << 30, "pil": 2 * 89478485}
MAX_SIDE = {"cv2": 1 << 20, "pil": 1 << 31}


def check_size(w: int, h: int, rule: str, name: str) -> None:
    """ValueError when ``rule``'s library refuses a ``w`` x ``h`` image."""
    if w * h > MAX_PIXELS[rule] or max(w, h) > MAX_SIDE[rule]:
        raise ValueError(f"{name}: an image of {w}x{h} pixels, over {rule}'s limit of "
                         f"{MAX_PIXELS[rule]} pixels (or {MAX_SIDE[rule]} a side)")


def image_format(data: bytes) -> str:
    """The format named by a file's first bytes: jpeg, png, bmp, tiff, webp
    or unknown."""
    if data[:3] == b"\xff\xd8\xff":
        return "jpeg"
    if data[:8] == PNG_SIGNATURE:
        return "png"
    if data[:2] == b"BM":
        return "bmp"
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        return "tiff"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "webp"
    return "unknown"


def decode_bytes(data: bytes, rule: str = "cv2", name: str = "image") -> np.ndarray:
    """An image file's bytes -> HWC RGB uint8 by ``rule`` ("cv2" or "pil").
    ValueError for bytes that are no image, a truncated header or an image
    over the rule's size limit; NotImplementedError for TIFF and WebP (item
    21) and for the JPEG variants the codec leaves out."""
    if rule not in RULES:
        raise ValueError(f"rule {rule!r}: one of {RULES}")
    fmt = image_format(data)
    if fmt == "jpeg":
        try:
            img = image_codec.jpeg_decode(data, MAX_PIXELS[rule])
        except NotImplementedError as e:
            raise NotImplementedError(f"{name}: {e} (ROADMAP queue 1, item 9f)") from None
        except ValueError as e:
            raise ValueError(f"{name}: {e}") from None
        return apply_orientation(img, exif_orientation(data)) if rule == "cv2" else img
    try:
        if fmt == "png":
            return decode_png(data, name, rule)
        if fmt == "bmp":
            return decode_bmp(data, name, rule)
    except struct.error:
        raise ValueError(f"{name}: truncated {fmt.upper()} header") from None
    if fmt in ("tiff", "webp"):
        raise NotImplementedError(f"{name}: {fmt.upper()} images are not decoded by the port "
                                  f"({_UNPORTED})")
    raise ValueError(f"{name}: not an image file (JPEG, PNG or BMP)")


def imread(path: Union[str, Path], rule: str = "cv2") -> np.ndarray:
    """HWC RGB uint8 of an image file by ``rule`` (``decode_bytes``);
    FileNotFoundError when there is no such file."""
    p = Path(path)
    if not p.is_file():
        raise FileNotFoundError(str(path))
    return decode_bytes(p.read_bytes(), rule, str(path))


def encode_jpeg(img: np.ndarray, style: str = "pil") -> bytes:
    """HWC RGB uint8 -> the JPEG bytes that PIL (``style="pil"``) or cv2
    (``style="cv2"``, given the same pixels in BGR) writes at its defaults."""
    if style not in JPEG_QUALITY:
        raise ValueError(f"style {style!r}: one of {tuple(JPEG_QUALITY)}")
    return image_codec.jpeg_encode(img, JPEG_QUALITY[style])


# ------------------------------------------------------------------ EXIF

def exif_orientation(data: bytes) -> int:
    """The EXIF orientation (1-8) of a JPEG's APP1 segment; 1 when absent."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker in (0xDA, 0xD9):  # the scan: no more header segments
            break
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        body = data[pos + 4:pos + 2 + length]
        if marker == 0xE1 and body[:6] == b"Exif\x00\x00":
            return _tiff_orientation(body[6:])
        pos += 2 + length
    return 1


def _tiff_orientation(t: bytes) -> int:
    if len(t) < 8 or t[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if t[:2] == b"II" else ">"
    ifd = struct.unpack(e + "I", t[4:8])[0]
    if ifd + 2 > len(t):
        return 1
    for i in range(struct.unpack(e + "H", t[ifd:ifd + 2])[0]):
        entry = t[ifd + 2 + 12 * i:ifd + 14 + 12 * i]
        if len(entry) < 12:
            break
        tag, typ = struct.unpack(e + "HH", entry[:4])
        if tag == 0x0112 and typ == 3:  # Orientation, SHORT
            v = struct.unpack(e + "H", entry[8:10])[0]
            return v if 1 <= v <= 8 else 1
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's ``ApplyExifOrientation``: the transform that shows the image
    upright (2 mirror, 3 rotate 180, 4 flip, 5 transpose, 6 rotate 90
    clockwise, 7 transverse, 8 rotate 90 anticlockwise)."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


# ------------------------------------------------------------------ PNG

def _png_chunks(data: bytes):
    pos = 8
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        yield ctype, data[pos + 8:pos + 8 + length]
        if ctype == b"IEND":
            return
        pos += 12 + length


def _unpack(rows: np.ndarray, depth: int, width: int, channels: int) -> np.ndarray:
    """(h, stride) unfiltered bytes -> (h, width, channels) samples."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").reshape(h, -1)[:, :width * channels].astype(np.uint16).reshape(
            h, width, channels)
    if depth == 8:
        return rows[:, :width * channels].reshape(h, width, channels)
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
    vals = (bits.astype(np.uint8) << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(
        -1, dtype=np.uint8)
    return vals[:, :width].reshape(h, width, 1)


def decode_png(data: bytes, name: str = "image", rule: str = "cv2") -> np.ndarray:
    """A PNG of any standard bit depth and colour type, interlaced or not
    -> HWC RGB uint8 by ``rule``: alpha and ``tRNS`` dropped, palettes
    looked up, grey below 8 bits scaled to 0-255 (as libpng and Pillow
    both scale); 16-bit samples keep their high byte, except under PIL's
    rule a 16-bit grey image, which Pillow clips to 255. cv2 applies an
    ``eXIf`` chunk's orientation, PIL does not."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    header, palette, idat, orientation = None, None, [], 1
    for ctype, body in _png_chunks(data):
        if ctype == b"eXIf":
            orientation = _tiff_orientation(body)
        elif ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8)[:len(body) // 3 * 3].reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: PNG without IHDR")
    w, h, depth, color, compression, filtering, interlace = header
    if color not in _PNG_CHANNELS or depth not in _PNG_DEPTHS[color]:
        raise ValueError(f"{name}: PNG with bit depth {depth} and colour type {color}")
    if compression or filtering or interlace > 1 or w == 0 or h == 0:
        raise ValueError(f"{name}: bad PNG header")
    check_size(w, h, rule, name)
    if color == 3 and palette is None:
        raise ValueError(f"{name}: palette PNG without PLTE")
    ch = _PNG_CHANNELS[color]
    bpp = max(1, ch * depth // 8)
    passes = [(0, 0, 1, 1, w, h)] if not interlace else [
        (x0, y0, dx, dy, (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy)
        for x0, y0, dx, dy in _ADAM7]
    passes = [p for p in passes if p[4] > 0 and p[5] > 0]
    strides = [(pw * ch * depth + 7) // 8 for *_, pw, _ph in passes]
    size = sum(p[5] * (stride + 1) for p, stride in zip(passes, strides))
    try:  # inflated no further than the image's own bytes
        raw = np.frombuffer(zlib.decompressobj().decompress(b"".join(idat), size), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{name}: {e}") from None
    samples = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for (x0, y0, dx, dy, pw, ph), stride in zip(passes, strides):
        rows = image_codec.png_unfilter(raw[pos:pos + ph * (stride + 1)], ph, stride, bpp, name)
        samples[y0::dy, x0::dx] = _unpack(rows, depth, pw, ch)
        pos += ph * (stride + 1)
    img = _png_rgb(samples, color, depth, palette, rule)
    return apply_orientation(img, orientation) if rule == "cv2" else img


def _png_rgb(samples, color, depth, palette, rule):
    if color == 3:
        lut = np.zeros((256, 3), np.uint8)  # indices past the palette read black
        lut[:len(palette)] = palette[:256]
        return lut[samples[..., 0]]
    ch = samples.shape[-1]
    if depth == 16:
        if rule == "pil" and ch == 1:
            samples = np.minimum(samples, 255)
        else:
            samples = samples >> 8
        samples = samples.astype(np.uint8)
    elif depth < 8:
        samples = samples * np.uint8(255 // ((1 << depth) - 1))
    if ch <= 2:
        return np.repeat(samples[..., :1], 3, axis=2)
    return np.ascontiguousarray(samples[..., :3])


# ------------------------------------------------------------------ BMP

def decode_bmp(data: bytes, name: str = "image", rule: str = "cv2") -> np.ndarray:
    """An uncompressed BMP (1-, 4- or 8-bit palette, 24- or 32-bit; rows
    bottom-up or, with a negative height, top-down) -> HWC RGB uint8; a
    32-bit image's fourth byte is dropped. ``rule`` sets the size limit."""
    if data[:2] != b"BM" or len(data) < 26:
        raise ValueError(f"{name}: not a BMP file")
    offset, dib = struct.unpack("<II", data[10:18])
    if dib == 12:  # BITMAPCOREHEADER
        w, h, _, bits = struct.unpack("<HHHH", data[18:26])
        compression, colors, entry = 0, 0, 3
    elif dib >= 40:
        w, h, _, bits, compression = struct.unpack("<iiHHI", data[18:34])
        colors = struct.unpack("<I", data[46:50])[0]
        entry = 4
    else:
        raise ValueError(f"{name}: bad BMP header size {dib}")
    if compression not in (0, 3) or (compression == 3 and bits not in (16, 32)):
        raise NotImplementedError(f"{name}: compressed BMP (compression {compression}) "
                                  f"({_UNPORTED})")
    if compression == 3:
        masks = struct.unpack("<III", data[54:66])
        if bits != 32 or masks != (0xFF0000, 0xFF00, 0xFF):
            raise NotImplementedError(f"{name}: BMP with bit fields {masks} ({_UNPORTED})")
    if bits not in (1, 4, 8, 24, 32):
        raise NotImplementedError(f"{name}: {bits}-bit BMP ({_UNPORTED})")
    top_down, h = h < 0, abs(h)
    if w <= 0 or h == 0:
        raise ValueError(f"{name}: bad BMP size {w}x{h}")
    check_size(w, h, rule, name)
    stride = (w * bits + 31) // 32 * 4
    if offset + stride * h > len(data):
        raise ValueError(f"{name}: truncated BMP")
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)
    if not top_down:
        rows = rows[::-1]
    if bits >= 24:
        bgr = rows[:, :w * bits // 8].reshape(h, w, bits // 8)[..., :3]
        return np.ascontiguousarray(bgr[..., ::-1])
    n = colors or (1 << bits)
    pal = np.frombuffer(data, np.uint8, n * entry, 14 + dib).reshape(n, entry)[:, 2::-1]
    lut = np.zeros((256, 3), np.uint8)
    lut[:n] = pal[:256]
    idx = _unpack(np.ascontiguousarray(rows), bits, w, 1)[..., 0] if bits < 8 else rows[:, :w]
    return lut[idx]
