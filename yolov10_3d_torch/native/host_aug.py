"""The host augmentation's image operations in C++ (``host_aug.cc``), built
with g++ at first use into ``_build/`` and loaded with ctypes.

Each function equals its numpy version bit for bit: ``warp_affine``,
``warp_perspective`` and ``hsv_lut`` those of ``data/cv2_rules.py``,
``resize_linear`` that of ``data/preprocess.py``. ctypes releases the
interpreter lock for the call, so the loader's threads run in parallel. A
library that does not build raises ``RuntimeError`` with the compiler's
message: the loader has no numpy fall-back, as the JAX package has none for
its cv2.

The flags add ``-mfma`` where the host's CPU has FMA (hardware fused
multiply-adds; without it ``std::fma`` is the C library's, slower and just
as exact); the library's file name hashes the flags.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

from . import NativeLibrary

SRC = Path(__file__).resolve().parent / "host_aug.cc"


def _cpu_has_fma() -> bool:
    try:
        flags = next((ln for ln in Path("/proc/cpuinfo").read_text().splitlines()
                      if ln.startswith("flags")), "")
    except OSError:
        return False
    return "fma" in flags.split()


def gxx_flags() -> Tuple[str, ...]:
    return ("-O3", "-shared", "-fPIC", "-ffp-contract=off") + (("-mfma",) if _cpu_has_fma() else ())


def _setup(lib: ctypes.CDLL) -> None:
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i = ctypes.c_int
    lib.warp_u8c3.argtypes = [u8p, i, i, u8p, i, i, f64p, i, u8p]
    lib.warp_u8c3.restype = ctypes.c_int
    lib.resize_linear_u8c3.argtypes = [u8p, i, i, u8p, i, i]
    lib.resize_linear_u8c3.restype = None
    lib.hsv_lut_u8c3.argtypes = [u8p, i, i, u8p]
    lib.hsv_lut_u8c3.restype = None


_LIBRARY = NativeLibrary(SRC, gxx_flags(), _setup)


def get_lib() -> ctypes.CDLL:
    """The library, built on first use; raises with the build's error."""
    lib = _LIBRARY.load()
    if lib is None:
        raise RuntimeError(f"the host augmentation library ({SRC.name}) did not build: "
                           f"{_LIBRARY.error}")
    return lib


def _image(img: np.ndarray) -> np.ndarray:
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) uint8 image, got {img.dtype} {img.shape}")
    return np.ascontiguousarray(img)


def _warp(img, M, dsize, border_value, perspective: bool) -> np.ndarray:
    src = _image(img)
    w, h = int(dsize[0]), int(dsize[1])
    out = np.empty((h, w, 3), np.uint8)
    m = np.ascontiguousarray(np.asarray(M, np.float64).reshape(-1)[: 9 if perspective else 6])
    border = np.asarray(border_value, np.uint8).reshape(3)
    if get_lib().warp_u8c3(src, src.shape[0], src.shape[1], out, h, w, m, int(perspective),
                           border) != 0:
        raise ValueError("warp_perspective: the matrix is singular")
    return out


def warp_affine(img: np.ndarray, M, dsize: Tuple[int, int],
                border_value: Sequence[int] = (114, 114, 114)) -> np.ndarray:
    """``cv2_rules.warp_affine``: forward (2, 3) ``M``, dsize (w, h)."""
    return _warp(img, M, dsize, border_value, False)


def warp_perspective(img: np.ndarray, M, dsize: Tuple[int, int],
                     border_value: Sequence[int] = (114, 114, 114)) -> np.ndarray:
    """``cv2_rules.warp_perspective``: forward (3, 3) ``M``, dsize (w, h)."""
    return _warp(img, M, dsize, border_value, True)


def resize_linear(img: np.ndarray, new_wh: Tuple[int, int]) -> np.ndarray:
    """``preprocess.resize_linear``: cv2 INTER_LINEAR to (w, h)."""
    src = _image(img)
    w, h = int(new_wh[0]), int(new_wh[1])
    out = np.empty((h, w, 3), np.uint8)
    get_lib().resize_linear_u8c3(src, src.shape[0], src.shape[1], out, h, w)
    return out


def hsv_lut(img: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """``cv2_rules.hsv_lut``: RGB -> HSV -> ``lut`` (256, 3) -> RGB, on a copy."""
    out = np.array(_image(img), copy=True)
    get_lib().hsv_lut_u8c3(out, out.shape[0], out.shape[1],
                           np.ascontiguousarray(np.asarray(lut, np.uint8).reshape(256, 3)))
    return out
