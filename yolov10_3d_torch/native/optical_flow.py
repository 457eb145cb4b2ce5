"""The camera-motion estimate's pyramidal Lucas-Kanade flow in C++
(``optical_flow.cc``), built with g++ at first use into ``_build/`` and
loaded with ctypes.

``optical_flow`` equals ``trackers/gmc.py``'s numpy rule of the same name
bit for bit (``tests/test_torch_track.py`` holds it) and is what
``GMC.apply`` runs: the rule's lockstep over all points costs tens of
milliseconds a frame in numpy. A library that does not build raises
``RuntimeError`` with the compiler's message, as the host augmentation's
does.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import numpy as np

from . import NativeLibrary

SRC = Path(__file__).resolve().parent / "optical_flow.cc"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-ffp-contract=off")


def _setup(lib: ctypes.CDLL) -> None:
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i, d = ctypes.c_int, ctypes.c_double
    lib.lk_flow.argtypes = [u8p, u8p, i, i, f32p, i, i, i, i, d, d, f32p, u8p]
    lib.lk_flow.restype = None


_LIBRARY = NativeLibrary(SRC, GXX_FLAGS, _setup)


def get_lib() -> ctypes.CDLL:
    """The library, built on first use; raises with the build's error."""
    lib = _LIBRARY.load()
    if lib is None:
        raise RuntimeError(f"the optical flow library ({SRC.name}) did not build: "
                           f"{_LIBRARY.error}")
    return lib


def optical_flow(prev: np.ndarray, nxt: np.ndarray, pts: np.ndarray, win: int, levels: int,
                 iters: int, eps: float, min_eig: float) -> Tuple[np.ndarray, np.ndarray]:
    """``trackers/gmc.py`` ``optical_flow`` (same arguments, same results)."""
    prev, nxt = (np.ascontiguousarray(a, np.uint8) for a in (prev, nxt))
    if prev.ndim != 2 or prev.shape != nxt.shape:
        raise ValueError(f"expected two (H, W) uint8 frames, got {prev.shape} and {nxt.shape}")
    pts = np.ascontiguousarray(np.asarray(pts, np.float32).reshape(-1, 2))
    out = np.zeros_like(pts)
    status = np.zeros(len(pts), np.uint8)
    get_lib().lk_flow(prev, nxt, prev.shape[0], prev.shape[1], pts, len(pts), win, levels, iters,
                      eps, min_eig, out, status)
    return out, status
