"""ctypes binding of the host data path's C++ bilinear resize
(`native/resize.cpp`; counterpart of `robot_aware_control_tpu/data/native.py`).

The library is compiled with `c++ -O3 -shared -fPIC` at first use into
`robot_aware_control_tpu_torch/_build/`, under a name that hashes the
source and the flags. A failed build is not hidden: `bilinear_resize`
raises with the compiler's output, and `available()` says False.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "resize.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None
_error = None  # the failed build's message, kept so that it is tried once


def _lib_path() -> str:
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"resize_{digest.hexdigest()[:16]}.so")


def _build_and_load():
    """The bound library; raises RuntimeError with the compiler's output
    (or the loader's error) if it cannot be built."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                _lib = _load(_build())
            except (OSError, subprocess.SubprocessError) as e:
                out = getattr(e, "stderr", None) or getattr(e, "output", None)
                _error = f"{type(e).__name__}: {e}" + (f"\n{out}" if out else "")
        if _lib is None:
            raise RuntimeError(f"the native resize could not be built: {_error}")
        return _lib


def _build() -> str:
    path = _lib_path()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        subprocess.run(["c++", *FLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, path)  # atomic: concurrent processes see whole files
    return path


def _load(path: str):
    lib = ctypes.CDLL(path)
    fp, i = ctypes.POINTER(ctypes.c_float), ctypes.c_int
    lib.bilinear_resize_batch_f32.argtypes = [fp, i, i, i, i, fp, i, i]
    lib.bilinear_resize_batch_f32.restype = None
    return lib


def available() -> bool:
    try:
        _build_and_load()
    except RuntimeError:
        return False
    return True


def bilinear_resize_batch(imgs: np.ndarray, w: int, h: int) -> np.ndarray:
    """imgs (N, H, W, C), any numeric dtype -> (N, h, w, C) float32,
    bilinear with half-pixel centres (torchvision / cv2 semantics)."""
    lib = _build_and_load()
    x = np.ascontiguousarray(imgs, np.float32)
    if x.ndim != 4 or min(x.shape) < 1 or w < 1 or h < 1:
        raise ValueError(f"resize of {x.shape} to {h}x{w}")
    N, H, W, C = x.shape
    out = np.empty((N, h, w, C), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.bilinear_resize_batch_f32(x.ctypes.data_as(fp), N, H, W, C,
                                  out.ctypes.data_as(fp), h, w)
    return out


def bilinear_resize(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """img (H, W[, C]) -> (h, w[, C]) float32."""
    img = np.asarray(img)
    x = img[None, ..., None] if img.ndim == 2 else img[None]
    out = bilinear_resize_batch(x, w, h)[0]
    return out[..., 0] if img.ndim == 2 else out
