"""ctypes bindings for the native dataset runtime (runtime/loader.cpp).

Builds the shared library from loader.cpp on first use (g++ via make; the
library is not kept in git); callers fall back to the pure-Python cv2 path
in io/tum.py when the toolchain or libpng is missing.  Plain C ABI + ctypes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Iterator, List, Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libboslam_runtime.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO):
        # Build under a private name, then rename: concurrent first uses
        # (e.g. test workers) never load a half-written library.
        tmp = f"{_SO}.{os.getpid()}.tmp"
        try:
            subprocess.run(
                ["make", "-C", _DIR, "-s", f"OUT={tmp}"], check=True,
                capture_output=True,
            )
            os.replace(tmp, _SO)
        except (OSError, subprocess.CalledProcessError):
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.loader_next.restype = ctypes.c_int
    lib.loader_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
    ]
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    lib.decode_rgb_gray.restype = ctypes.c_int
    lib.decode_rgb_gray.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.decode_depth.restype = ctypes.c_int
    lib.decode_depth.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float),
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def decode_frame(
    rgb_path: str, depth_path: str, width: int, height: int,
    depth_factor: float = 5000.0,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(gray f32 [H,W] in [0,255], depth f32 metres [H,W]) or None."""
    lib = _load()
    if lib is None:
        return None
    gray = np.empty((height, width), np.float32)
    depth = np.empty((height, width), np.float32)
    ok1 = lib.decode_rgb_gray(
        rgb_path.encode(), width, height,
        gray.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    ok2 = lib.decode_depth(
        depth_path.encode(), width, height, depth_factor,
        depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if not (ok1 and ok2):
        return None
    return gray, depth


class NativeLoader:
    """Prefetching TUM frame stream backed by the C++ worker pool."""

    def __init__(
        self,
        rgb_paths: List[str],
        depth_paths: List[str],
        width: int,
        height: int,
        depth_factor: float = 5000.0,
        n_threads: int = 3,
        capacity: int = 8,
    ):
        lib = _load()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        self._w, self._h = width, height
        self._n = len(rgb_paths)
        rgb_arr = (ctypes.c_char_p * self._n)(*[p.encode() for p in rgb_paths])
        dep_arr = (ctypes.c_char_p * self._n)(*[p.encode() for p in depth_paths])
        self._handle = lib.loader_create(
            rgb_arr, dep_arr, self._n, width, height,
            ctypes.c_float(depth_factor), n_threads, capacity,
        )

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for _ in range(self._n):
            gray = np.empty((self._h, self._w), np.float32)
            depth = np.empty((self._h, self._w), np.float32)
            rc = self._lib.loader_next(
                self._handle,
                gray.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
            if rc < 0:
                return
            if rc == 0:
                continue  # unreadable frame: skip
            yield gray, depth

    def close(self) -> None:
        if self._handle:
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
