"""ctypes binding of the C++ JPEG batch loader: the port of
``learning_embeddings_tpu/data/native_loader.py``.

``csrc/le_loader.cc`` (a copy of the JAX package's ``native/le_loader.cc``)
decodes each JPEG with libjpeg (DCT-scaled where the source is much larger
than needed), samples the bilinear resize at the random-crop window, flips
and writes float32 in [0, 1] or rounded uint8, all in one pass per image on
its own threads. ``load_augment_batch`` and ``resize_bilinear`` call it.

The library is built with g++ and libjpeg (``csrc/Makefile``) into
``<checkout>/.torch_kernels/native/`` on the first call of a process (make
rebuilds it when the source is newer). Unlike the JAX module there is no
``available()`` and no quiet fallback: a failed build raises with the
compiler's output, a library that does not load or is older than version 2
raises, and the caller (``ImagePipeline(loader='native')``) asked for this
loader by name.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Sequence, Tuple

import numpy as np

__all__ = ["load_augment_batch", "resize_bilinear", "build_library",
           "LIB_VERSION"]

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_CSRC)),
                          ".torch_kernels", "native")
_LIB_PATH = os.path.join(_BUILD_DIR, "lible_loader.so")
#: the library version this binding speaks (``le_version()``)
LIB_VERSION = 2

_lock = threading.Lock()
_lib = None


def build_library() -> str:
    """Builds (or brings up to date) the loader library; returns its path.
    Raises RuntimeError with make's and the compiler's output if the build
    fails."""
    cmd = ["make", "-C", _CSRC, f"OUT={_BUILD_DIR}"]
    try:
        run = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise RuntimeError(f"native loader: {' '.join(cmd)} did not run: "
                           f"{exc}") from exc
    if run.returncode != 0 or not os.path.exists(_LIB_PATH):
        raise RuntimeError(
            f"native loader: the build failed ({' '.join(cmd)}, exit "
            f"{run.returncode}; it needs g++ and libjpeg's jpeglib.h):\n"
            f"{run.stdout}{run.stderr}")
    return _LIB_PATH


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build_library())
        lib.le_version.restype = ctypes.c_int
        lib.le_version.argtypes = []
        version = lib.le_version()
        if version < LIB_VERSION:
            # dlopen keeps the stale library for this process: rebuilding
            # would help only the next one
            raise RuntimeError(
                f"native loader: {_LIB_PATH} is version {version}, this "
                f"binding needs {LIB_VERSION}; remove it and rerun")
        for name, out_t in (("le_load_augment_batch", ctypes.c_float),
                            ("le_load_augment_batch_u8", ctypes.c_uint8)):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
                ctypes.POINTER(out_t), ctypes.POINTER(ctypes.c_int)]
        lib.le_resize_bilinear.restype = None
        lib.le_resize_bilinear.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.c_int]
        _lib = lib
        return _lib


def load_augment_batch(paths: Sequence[str], size: int, *, pad: int = 64,
                       train: bool = True, grayscale: bool = False,
                       seed: int = 0,
                       out_dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """(batch (N, S, S, C), status (N,) int32, 0 = ok) of the JPEG files
    at `paths`: train = resize to (S + pad)², random S² crop and flip
    (pad=0: resize and flip), else a plain resize; element i draws from
    seed + i·0x9E3779B97F4A7C15. float32 output is in [0, 1]; uint8 is
    the rounded pixel (one rounding more than float32·255)."""
    lib = _load()
    if size <= 0 or pad < 0:
        raise ValueError(f"size must be > 0 and pad ≥ 0, got {size}, {pad}")
    n = len(paths)
    c = 1 if grayscale else 3
    u8 = np.dtype(out_dtype) == np.uint8
    if not u8 and np.dtype(out_dtype) != np.float32:
        raise ValueError(f"out_dtype must be float32 or uint8, got "
                         f"{out_dtype}")
    out = np.empty((n, size, size, c), np.uint8 if u8 else np.float32)
    status = np.empty((n,), np.int32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    fn = lib.le_load_augment_batch_u8 if u8 else lib.le_load_augment_batch
    fn(arr, n, size, pad, int(train), int(grayscale), seed,
       out.ctypes.data_as(ctypes.POINTER(
           ctypes.c_uint8 if u8 else ctypes.c_float)),
       status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return out, status


def resize_bilinear(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Half-pixel bilinear resize of an HWC uint8 image (cv2's
    INTER_LINEAR up to one level)."""
    lib = _load()
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3:
        raise ValueError(f"expected an HWC image, got shape {img.shape}")
    h, w, c = img.shape
    out = np.empty((oh, ow, c), np.uint8)
    lib.le_resize_bilinear(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, c,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), oh, ow)
    return out
