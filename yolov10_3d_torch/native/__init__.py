"""Host code in C++, built with g++ at first use and loaded with ctypes:
the rotated IoU of the KITTI evaluator (``kitti_iou.cc``, here), the host
augmentation's image operations (``host_aug.cc``, ``native/host_aug.py``)
and the image codec (``image_codec.cc``, ``native/image_codec.py``).

A library goes to ``_build/`` beside the package (git-ignored), named by a
hash of its source and flags, so an edited source is rebuilt. For the
rotated IoU the rule is the JAX package's: the evaluator uses the library
when g++ builds it and the numpy implementation otherwise. A failed build is
reported by a warning that carries the compiler's message, and
``build_error()`` returns it. (The host augmentation and the codec raise
instead.)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np

SRC = Path(__file__).resolve().parent / "kitti_iou.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")


class NativeLibrary:
    """A library built from ``src`` with ``flags`` on first request and set
    up by ``setup(lib)`` (its argtypes); one build attempt per process, which
    threads asking at once wait for."""

    def __init__(self, src: Path, flags: Sequence[str], setup: Callable[[ctypes.CDLL], None]):
        self.src, self.flags, self.setup = src, tuple(flags), setup
        self.lib: Optional[ctypes.CDLL] = None
        self.error: Optional[str] = None
        self.tried = False
        self._lock = threading.Lock()

    def path(self) -> Path:
        digest = hashlib.sha1(self.src.read_bytes() + " ".join(self.flags).encode()).hexdigest()
        return BUILD_DIR / f"{self.src.stem}-{digest[:12]}.so"

    def _build(self, out: Path) -> None:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *self.flags, "-o", str(tmp), str(self.src)], check=True,
                           capture_output=True, text=True, timeout=120)
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)

    def load(self) -> Optional[ctypes.CDLL]:
        """The library, or None with ``self.error`` set."""
        with self._lock:
            if not self.tried:
                self._load()
                self.tried = True
        return self.lib

    def _load(self) -> None:
        out = self.path()
        try:
            if not out.exists():
                self._build(out)
            lib = ctypes.CDLL(str(out))
        except subprocess.CalledProcessError as e:
            self.error = f"g++ exited {e.returncode}: {e.stderr.strip()}"
        except (OSError, subprocess.SubprocessError) as e:
            self.error = f"{type(e).__name__}: {e}"
        else:
            self.setup(lib)
            self.lib = lib


def _setup_kitti_iou(lib: ctypes.CDLL) -> None:
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.rotated_intersection_areas.argtypes = [f32p, ctypes.c_int, f32p, ctypes.c_int, f32p]
    lib.rotated_iou.argtypes = [f32p, ctypes.c_int, f32p, ctypes.c_int, ctypes.c_int, f32p]
    lib.iou_3d.argtypes = [f32p, ctypes.c_int, f32p, ctypes.c_int, ctypes.c_int, f32p]
    for fn in (lib.rotated_intersection_areas, lib.rotated_iou, lib.iou_3d):
        fn.restype = None


class _Library(NativeLibrary):
    """The rotated IoU's library (``SRC``); a failed build warns."""

    def __init__(self):
        super().__init__(SRC, GXX_FLAGS, _setup_kitti_iou)

    def get(self) -> Optional[ctypes.CDLL]:
        if self.tried:
            return self.lib
        lib = self.load()
        if lib is None:
            warnings.warn(f"the native rotated IoU ({SRC.name}) did not build ({self.error}); "
                          "the KITTI evaluator uses its numpy implementation", RuntimeWarning)
        return lib


_LIBRARY = _Library()


def get_lib() -> Optional[ctypes.CDLL]:
    """The library, or None when it could not be built (see ``build_error``)."""
    return _LIBRARY.get()


def build_error() -> Optional[str]:
    """Why the library is missing, or None (built, or not yet asked for)."""
    return _LIBRARY.error


def _pairs(fn, a: np.ndarray, b: np.ndarray, *args) -> np.ndarray:
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    out = np.empty((len(a), len(b)), np.float32)
    fn(a, len(a), b, len(b), *args, out)
    return out


def rotated_iou(boxes1: np.ndarray, boxes2: np.ndarray, criterion: int = -1) -> np.ndarray:
    """(N, 5), (M, 5) BEV boxes (cx, cz, l, w, ry) -> (N, M) rotated IoU;
    criterion -1 union, 0 area 1, 1 area 2."""
    return _pairs(_require().rotated_iou, boxes1, boxes2, criterion)


def iou_3d(g: np.ndarray, d: np.ndarray, criterion: int = -1) -> np.ndarray:
    """(N, 7), (M, 7) (x, y, z, l, h, w, ry; y the box bottom) -> (N, M) 3D IoU."""
    return _pairs(_require().iou_3d, g, d, criterion)


def _require() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"the native rotated IoU is not available: {build_error()}")
    return lib
