"""The image codec in C++ (``image_codec.cc``), built with g++ at first use
into ``_build/`` and loaded with ctypes: JPEG decoding and encoding, and the
PNG unfilter. ``data/image_io.py`` is its user; ``data/codec_rules.py``
states each of its stages in numpy.

``jpeg_decode`` and ``jpeg_encode`` return only the output (RGB pixels or
the file's bytes). ``jpeg_decode_stages`` and ``jpeg_encode_stages`` return
a ``Coded`` record: the output and, for each component, its coefficient
blocks (natural order), its quantisation table and its plane (the IDCT
output when decoding, the downsampled samples when encoding), so that each
stage can be held to its rule. A library that does not
build raises ``RuntimeError`` with the compiler's message; there is no
Python fall-back. ctypes releases the interpreter lock for each call.
"""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import List

import numpy as np

from . import NativeLibrary

SRC = Path(__file__).resolve().parent / "image_codec.cc"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
UNSUPPORTED = "unsupported: "  # the library's prefix for valid files it does not decode
MAX_PIXELS = 1 << 30  # cv2's default limit (CV_IO_MAX_IMAGE_PIXELS)


def _setup(lib: ctypes.CDLL) -> None:
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.codec_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_longlong]
    lib.codec_jpeg_encode.argtypes = [u8p, i, i, i, i]
    for fn in (lib.codec_jpeg_decode, lib.codec_jpeg_encode):
        fn.restype = vp
    lib.codec_error.argtypes = [vp]
    lib.codec_error.restype = ctypes.c_char_p
    lib.codec_info.argtypes = [vp, i32p]
    lib.codec_component.argtypes = [vp, i, i32p]
    lib.codec_copy_coefs.argtypes = [vp, i, np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")]
    lib.codec_copy_qtable.argtypes = [vp, i, np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")]
    lib.codec_copy_plane.argtypes = [vp, i, u8p]
    lib.codec_output_size.argtypes = [vp]
    lib.codec_output_size.restype = ctypes.c_long
    lib.codec_copy_output.argtypes = [vp, u8p]
    lib.codec_free.argtypes = [vp]
    for fn in (lib.codec_info, lib.codec_component, lib.codec_copy_coefs, lib.codec_copy_qtable,
               lib.codec_copy_plane, lib.codec_copy_output, lib.codec_free):
        fn.restype = None
    lib.png_unfilter.argtypes = [u8p, i, i, i, u8p]
    lib.png_unfilter.restype = i


_LIBRARY = NativeLibrary(SRC, GXX_FLAGS, _setup)


def get_lib() -> ctypes.CDLL:
    """The library, built on first use; raises with the build's error."""
    lib = _LIBRARY.load()
    if lib is None:
        raise RuntimeError(f"the image codec ({SRC.name}) did not build: {_LIBRARY.error}")
    return lib


@dataclasses.dataclass
class Component:
    id: int
    h: int  # sampling factors
    v: int
    dw: int  # samples of the component that hold the image (downsampled width, height)
    dh: int
    blocks_real: tuple  # (rows, cols) of blocks holding samples
    coefs: np.ndarray  # (rows, cols, 8, 8) int16, natural order, quantised
    qtable: np.ndarray  # (8, 8) uint16
    plane: np.ndarray  # uint8: decoding the IDCT output of every block, encoding the
    # downsampled samples the FDCT reads


@dataclasses.dataclass
class Coded:
    height: int
    width: int
    hmax: int
    vmax: int
    progressive: bool
    transform: int  # 0 grey, 1 YCbCr, 2 RGB
    restart: int
    components: List[Component]
    output: np.ndarray  # decoding (H, W, 3) RGB uint8; encoding the file's bytes (uint8)


def _check(lib, handle) -> None:
    err = lib.codec_error(handle).decode()
    if err:
        if err.startswith(UNSUPPORTED):
            raise NotImplementedError(err[len(UNSUPPORTED):])
        raise ValueError(err)


def _output(lib, handle) -> np.ndarray:
    out = np.empty(lib.codec_output_size(handle), np.uint8)
    lib.codec_copy_output(handle, out)
    return out


def _stages(lib, handle, decoding: bool) -> Coded:
    info = np.zeros(8, np.int32)
    lib.codec_info(handle, info)
    H, W, nc, hmax, vmax, prog, transform, restart = (int(v) for v in info)
    comps = []
    for ci in range(nc):
        ki = np.zeros(12, np.int32)
        lib.codec_component(handle, ci, ki)
        cid, h, v, _tq, bw, bh, bw_real, bh_real, dw, dh, pw, rows = (int(x) for x in ki)
        coefs = np.empty((bh, bw, 8, 8), np.int16)
        lib.codec_copy_coefs(handle, ci, coefs)
        q = np.empty((8, 8), np.uint16)
        lib.codec_copy_qtable(handle, ci, q)
        plane = np.empty((rows, pw), np.uint8)
        lib.codec_copy_plane(handle, ci, plane)
        comps.append(Component(cid, h, v, dw, dh, (bh_real, bw_real), coefs, q, plane))
    out = _output(lib, handle)
    return Coded(H, W, hmax, vmax, bool(prog), transform, restart, comps,
                 out.reshape(H, W, 3) if decoding else out)


def _decode(data: bytes, max_pixels: int, stages: bool):
    lib = get_lib()
    handle = lib.codec_jpeg_decode(bytes(data), len(data), int(max_pixels))
    try:
        _check(lib, handle)
        if stages:
            return _stages(lib, handle, True)
        info = np.zeros(8, np.int32)
        lib.codec_info(handle, info)
        return _output(lib, handle).reshape(int(info[0]), int(info[1]), 3)
    finally:
        lib.codec_free(handle)


def jpeg_decode(data: bytes, max_pixels: int = MAX_PIXELS) -> np.ndarray:
    """A JPEG file -> (H, W, 3) RGB uint8 as libjpeg-turbo decodes it (no
    EXIF rotation). NotImplementedError for what the library leaves out
    (arithmetic coding, 12-bit samples, CMYK/YCCK, lossless); ValueError
    for a broken file and for a frame of more than ``max_pixels`` pixels,
    refused before anything is allocated."""
    return _decode(data, max_pixels, False)


def jpeg_decode_stages(data: bytes, max_pixels: int = MAX_PIXELS) -> Coded:
    """``jpeg_decode`` with every stage kept (``Coded``)."""
    return _decode(data, max_pixels, True)


def _encode(img: np.ndarray, quality: int, stages: bool):
    img = np.ascontiguousarray(img, np.uint8)
    channels = 1 if img.ndim == 2 else img.shape[2]
    if channels not in (1, 3):
        raise ValueError(f"JPEG encoding takes grey or RGB images, not {channels} channels")
    lib = get_lib()
    handle = lib.codec_jpeg_encode(img.reshape(-1), img.shape[0], img.shape[1], channels,
                                   int(quality))
    try:
        _check(lib, handle)
        return _stages(lib, handle, False) if stages else _output(lib, handle).tobytes()
    finally:
        lib.codec_free(handle)


def jpeg_encode(img: np.ndarray, quality: int) -> bytes:
    """HWC RGB (or HW grey) uint8 -> the bytes of a baseline JPEG as
    libjpeg-turbo writes it with its defaults at ``quality``: 4:2:0 YCbCr
    for RGB, JFIF 1.01."""
    return _encode(img, quality, False)


def jpeg_encode_stages(img: np.ndarray, quality: int) -> Coded:
    """``jpeg_encode`` with every stage kept (``Coded``; ``output`` holds
    the file's bytes as uint8)."""
    return _encode(img, quality, True)


def png_unfilter(raw: np.ndarray, rows: int, stride: int, bpp: int, name: str) -> np.ndarray:
    """``rows`` PNG scanlines (filter byte + ``stride`` bytes each) -> the
    (rows, stride) unfiltered bytes; ``bpp`` bytes per pixel (at least 1)."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != rows * (stride + 1):
        raise ValueError(f"{name}: PNG data has {raw.size} bytes, expected {rows * (stride + 1)}")
    out = np.empty((rows, stride), np.uint8)
    bad = get_lib().png_unfilter(raw, rows, stride, bpp, out)
    if bad >= 0:
        raise ValueError(f"{name}: bad PNG filter type {int(raw[bad * (stride + 1)])}")
    return out
