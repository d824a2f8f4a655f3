"""ctypes binding to the native C++ loader, ``native/fastloader.cpp``
(``instarevive_tpu/data/native_loader.py``): threaded libjpeg decode with
crop and flip, and float32 ``.npy`` reads, on the host. Every function
returns None when the shared library is not built or does not load here, and
the caller falls back to PIL and numpy.

Build once per machine: ``python native/build.py``.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Sequence

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "libfastloader.so",
)
_lib = None


def available() -> bool:
    return _load() is not None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:  # built against a libjpeg this machine lacks
        return None
    lib.fl_decode_crop.restype = ctypes.c_int
    lib.fl_decode_crop.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong,
        ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte),
    ]
    lib.fl_batch_decode.restype = ctypes.c_int
    lib.fl_batch_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_ulonglong), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
    ]
    lib.fl_load_npy_f32.restype = ctypes.c_int
    lib.fl_load_npy_f32.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
    ]
    _lib = lib
    return lib


def decode_crop(
    path: str, out_size: int, crop: str = "center", seed: int = 0, hflip: bool = False
) -> Optional[np.ndarray]:
    """JPEG -> (out_size, out_size, 3) uint8, or None on failure/unavailable."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((out_size, out_size, 3), np.uint8)
    rc = lib.fl_decode_crop(
        path.encode(), out_size, 1 if crop == "random" else 0, seed,
        1 if hflip else 0, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    return out if rc == 0 else None


def batch_decode(
    paths: Sequence[str],
    out_size: int,
    crop: str = "center",
    seeds: Optional[Sequence[int]] = None,
    hflips: Optional[Sequence[bool]] = None,
    num_threads: int = 8,
) -> Optional[np.ndarray]:
    """Threaded batch decode -> (N, S, S, 3) uint8."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, out_size, out_size, 3), np.uint8)
    seeds_arr = (ctypes.c_ulonglong * n)(*(seeds or [0] * n))
    flips_arr = (ctypes.c_int * n)(*[1 if f else 0 for f in (hflips or [False] * n)])
    rc = lib.fl_batch_decode(
        "\n".join(paths).encode(), n, out_size, 1 if crop == "random" else 0,
        seeds_arr, flips_arr, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        num_threads,
    )
    return out if rc == 0 else None


def load_npy_f32(path: str, max_elems: int = 1 << 26) -> Optional[np.ndarray]:
    """Native float32 .npy reader (the DMD pair files)."""
    lib = _load()
    if lib is None:
        return None
    buf = np.empty((max_elems,), np.float32)
    shape = (ctypes.c_longlong * 8)()
    ndim = ctypes.c_int(0)
    rc = lib.fl_load_npy_f32(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_elems, shape, ctypes.byref(ndim),
    )
    if rc != 0:
        return None
    shp = tuple(shape[i] for i in range(ndim.value))
    n = int(np.prod(shp)) if shp else 1
    return buf[:n].reshape(shp).copy()
