"""ctypes bindings for the native host runtime (native/octane_native.cc);
counterpart of octane_tpu.io.native, bound to the same library.

The library is built on demand with the repo Makefile (g++, no external
dependencies); every entry point has a NumPy version for machines without
a toolchain.  These are host helpers on numpy arrays, not device kernels.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "liboctane_native.so"))
_lock = threading.Lock()
_lib = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH):
            try:
                subprocess.run(["make", "-C", os.path.abspath(_NATIVE_DIR)],
                               check=True, capture_output=True, timeout=120)
            except Exception:
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.octane_requantize.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_int16), ctypes.c_int]
        lib.octane_epe_stats.argtypes = [
            ctypes.POINTER(ctypes.c_float)] * 4 + [
            ctypes.c_int64, ctypes.c_float,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def requantize(img: np.ndarray, vmin: float, vmax: float, scale: float,
               offset: float, nthreads: int = 0) -> np.ndarray:
    """Normalized [0, 255] image -> int16 radiance counts (multithreaded).

    counts = int16((img/255*(vmax-vmin) + vmin - offset) / scale), the
    interpolated-frame product re-quantization (oct_interp.cc:424-457).
    """
    img = np.ascontiguousarray(img, np.float32)
    lib = _load()
    if lib is None:
        # mirror the native/reference order: /255 in double, truncate to
        # float32 before the int16 C-cast (oct_interp.cc:431)
        span = np.float64(vmax) - np.float64(vmin)
        rad = (img.astype(np.float64) / 255.0 * span + vmin).astype(np.float32)
        return ((rad - np.float32(offset)) / np.float32(scale)).astype(np.int16)
    out = np.empty(img.shape, np.int16)
    lib.octane_requantize(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        img.size, vmin, vmax, scale, offset,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), nthreads)
    return out


def epe_stats(u1, v1, u2, v2, thresh: float = 0.1,
              nthreads: int = 0) -> Tuple[float, float, float]:
    """(mean_epe, max_epe, fraction_above_thresh) between two flow fields."""
    arrs = [np.ascontiguousarray(a, np.float32).reshape(-1)
            for a in (u1, v1, u2, v2)]
    lib = _load()
    if lib is None:
        e = np.hypot(arrs[0] - arrs[2], arrs[1] - arrs[3])
        return float(e.mean()), float(e.max()), float((e > thresh).mean())
    out = np.zeros(3, np.float64)
    lib.octane_epe_stats(
        *[a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for a in arrs],
        arrs[0].size, thresh,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), nthreads)
    return float(out[0]), float(out[1]), float(out[2])
