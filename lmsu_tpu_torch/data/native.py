"""ctypes bindings of the native host ops (native/bev_ops.cc) for the port.

The port's copy of lmsu_tpu/data/native.py. It loads the repository's
native/libbev_ops.so as it is (built with `make -C native`); it does not
build, edit or copy it. When the library is missing or does not load, every
binding returns None and its caller takes its numpy path.

The routes are not interchangeable for one sample: the native downsample
draws its subset with splitmix64 and a partial Fisher-Yates, the numpy path
with `default_rng(...).choice`, so the two pick different points from the
same seed. Each equals the JAX package's same route bit for bit
(tests/test_torch_pandaset.py). This is host code, not a device kernel;
`route()` says which one a process takes.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native", "libbev_ops.so")

_lib = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = _declare(ctypes.CDLL(_LIB_PATH))
    except (OSError, AttributeError):
        # Unloadable or a stale build (a symbol missing): as if absent.
        return None
    _lib = lib
    return lib


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p, u8p, i64p = (ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
                       ctypes.POINTER(ctypes.c_int64))
    f32, i64 = ctypes.c_float, ctypes.c_int64
    lib.rasterize_bev_first_write.restype = i64
    lib.rasterize_bev_first_write.argtypes = [f32p, f32p, i64p, i64, i64, i64,
                                              f32, f32, f32, f32, i64p]
    lib.sort_points_by_cell.restype = None
    lib.sort_points_by_cell.argtypes = [f32p, u8p, i64, i64, i64, i64,
                                        f32, f32, f32, f32, f32p, u8p]
    lib.sample_or_pad_points.restype = i64
    lib.sample_or_pad_points.argtypes = [f32p, i64, i64, ctypes.c_uint64, f32p, u8p]
    return lib


def native_available() -> bool:
    return _load() is not None


def route() -> str:
    """"native" when the library loads, else "numpy"."""
    return "native" if native_available() else "numpy"


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def rasterize_bev_native(
    x: np.ndarray, y: np.ndarray, labels: np.ndarray,
    grid_size: Tuple[int, int] = (64, 64),
    pc_range: Tuple[float, float, float, float] = (-50, 50, -50, 50),
) -> Optional[np.ndarray]:
    """First-write-wins rasterization (NaN coordinates dropped); None
    without the library."""
    lib = _load()
    if lib is None:
        return None
    H, W = grid_size
    x_min, x_max, y_min, y_max = pc_range
    x = np.ascontiguousarray(x, np.float32)
    y = np.ascontiguousarray(y, np.float32)
    labels = np.ascontiguousarray(labels, np.int64)
    out = np.empty((H, W), np.int64)
    lib.rasterize_bev_first_write(_ptr(x, ctypes.c_float), _ptr(y, ctypes.c_float),
                                  _ptr(labels, ctypes.c_int64), len(x), H, W,
                                  x_min, x_max, y_min, y_max, _ptr(out, ctypes.c_int64))
    return out


def sample_or_pad_native(points: np.ndarray, max_points: int, seed: int
                         ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Downsample without replacement above max_points, zero-pad below:
    (points [max_points, 4], valid [max_points]); None without the library."""
    lib = _load()
    if lib is None:
        return None
    points = np.ascontiguousarray(points, np.float32)
    out = np.empty((max_points, 4), np.float32)
    valid = np.empty((max_points,), np.uint8)
    lib.sample_or_pad_points(_ptr(points, ctypes.c_float), points.shape[0], max_points,
                             ctypes.c_uint64(seed), _ptr(out, ctypes.c_float),
                             _ptr(valid, ctypes.c_uint8))
    return out, valid.astype(bool)


def sort_points_by_cell_native(
    points: np.ndarray, grid_size: Tuple[int, int],
    pc_range: Tuple[float, float, float, float],
    point_valid: Optional[np.ndarray] = None,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Stable counting sort by BEV cell, invalid and out-of-range last;
    None without the library. pc_range is (x_min, x_max, y_min, y_max)."""
    lib = _load()
    if lib is None:
        return None
    H, W = grid_size
    x_min, x_max, y_min, y_max = pc_range
    points = np.ascontiguousarray(points, np.float32)
    n, dim = points.shape
    out = np.empty_like(points)
    valid_out = np.empty((n,), np.uint8)
    vp = None if point_valid is None else np.ascontiguousarray(point_valid, np.uint8)
    lib.sort_points_by_cell(_ptr(points, ctypes.c_float),
                            None if vp is None else _ptr(vp, ctypes.c_uint8),
                            n, dim, H, W, x_min, x_max, y_min, y_max,
                            _ptr(out, ctypes.c_float), _ptr(valid_out, ctypes.c_uint8))
    return out, valid_out.astype(bool)
