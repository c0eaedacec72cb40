"""ctypes bindings for the native host runtime (native/pointcloud.cc).

The library is optional: every entry point has a numpy fallback, so the
package works before `native/build.sh` has run. `available()` reports
whether the fast path is loaded. The build is also attempted lazily once
(cheap, a single TU).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native"
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libdeepvcp_native.so")

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(_LIB_PATH):
        build = os.path.join(_NATIVE_DIR, "build.sh")
        if os.path.exists(build):
            try:
                subprocess.run(
                    ["sh", build], check=True, capture_output=True, timeout=120
                )
            except Exception:
                return None
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.velodyne_num_points.restype = ctypes.c_int64
    lib.velodyne_num_points.argtypes = [ctypes.c_char_p]
    lib.velodyne_load_downsample.restype = ctypes.c_int
    lib.velodyne_load_downsample.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint64, _f32p,
    ]
    lib.velodyne_read.restype = ctypes.c_int64
    lib.velodyne_read.argtypes = [ctypes.c_char_p, _f32p, ctypes.c_int64]
    lib.knn_bruteforce.restype = None
    lib.knn_bruteforce.argtypes = [
        _f32p, ctypes.c_int64, _f32p, ctypes.c_int64, ctypes.c_int64,
        _f32p, _i32p,
    ]
    lib.farthest_point_sample.restype = None
    lib.farthest_point_sample.argtypes = [
        _f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _i32p,
    ]
    lib.query_ball_point.restype = None
    lib.query_ball_point.argtypes = [
        _f32p, ctypes.c_int64, _f32p, ctypes.c_int64, ctypes.c_float,
        ctypes.c_int64, _i32p,
    ]
    lib.make_pair.restype = None
    lib.make_pair.argtypes = [
        _f32p, ctypes.c_int64, ctypes.c_uint64, ctypes.c_float,
        _f32p, _f32p, _f32p,
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def velodyne_load(path: str) -> np.ndarray:
    """Raw [N, 4] float32 scan (x, y, z, reflectance), read natively when
    the library is available — bit-identical to the numpy
    read_velodyne_bin fallback (tested byte-for-byte,
    tests/test_native.py)."""
    lib = _load()
    if lib is not None:
        n = lib.velodyne_num_points(path.encode())
        if n >= 0:
            out = np.empty((n, 4), np.float32)
            if lib.velodyne_read(path.encode(), out, n) == n:
                return out
    from deepvcp.data.datasets import read_velodyne_bin

    return read_velodyne_bin(path)


def velodyne_load_downsample(
    path: str, n: int, seed: int = 0
) -> np.ndarray:
    """[n, 3] float32 xyz from a KITTI velodyne .bin, downsampled natively
    when the library is available."""
    lib = _load()
    if lib is not None:
        out = np.empty((n, 3), np.float32)
        rc = lib.velodyne_load_downsample(
            path.encode(), n, seed & (2**64 - 1), out
        )
        if rc == 0:
            return out
    # numpy fallback (ref KITTIDataset.py:11-16,39)
    from deepvcp.data.datasets import read_velodyne_bin
    from deepvcp.data.transforms import resample

    scan = read_velodyne_bin(path)[:, :3]
    return resample(scan, n, np.random.default_rng(seed)).astype(np.float32)


def knn(ref: np.ndarray, query: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Exact brute-force KNN oracle: (dist [M, k], idx [M, k])."""
    ref = np.ascontiguousarray(ref, np.float32)
    query = np.ascontiguousarray(query, np.float32)
    lib = _load()
    if lib is not None:
        dist = np.empty((query.shape[0], k), np.float32)
        idx = np.empty((query.shape[0], k), np.int32)
        lib.knn_bruteforce(
            ref, ref.shape[0], query, query.shape[0], k, dist, idx
        )
        return dist, idx
    d = np.sqrt(
        np.sum((query[:, None, :] - ref[None, :, :]) ** 2, -1)
    )
    idx = np.argsort(d, axis=-1, kind="stable")[:, :k].astype(np.int32)
    return np.take_along_axis(d, idx, -1).astype(np.float32), idx


def farthest_point_sample(
    xyz: np.ndarray, npoint: int, start_idx: int = 0
) -> np.ndarray:
    xyz = np.ascontiguousarray(xyz, np.float32)
    lib = _load()
    if lib is not None:
        out = np.empty(npoint, np.int32)
        lib.farthest_point_sample(xyz, xyz.shape[0], npoint, start_idx, out)
        return out
    dist = np.full(xyz.shape[0], np.inf)
    far = start_idx
    out = np.empty(npoint, np.int32)
    for i in range(npoint):
        out[i] = far
        d = np.sum((xyz - xyz[far]) ** 2, -1)
        dist = np.minimum(dist, d)
        far = int(np.argmax(dist))
    return out


def query_ball_point(
    xyz: np.ndarray, queries: np.ndarray, radius: float, nsample: int
) -> np.ndarray:
    xyz = np.ascontiguousarray(xyz, np.float32)
    queries = np.ascontiguousarray(queries, np.float32)
    lib = _load()
    if lib is not None:
        out = np.empty((queries.shape[0], nsample), np.int32)
        lib.query_ball_point(
            xyz, xyz.shape[0], queries, queries.shape[0], radius, nsample, out
        )
        return out
    out = np.empty((queries.shape[0], nsample), np.int32)
    d2 = np.sum((queries[:, None, :] - xyz[None, :, :]) ** 2, -1)
    for q in range(queries.shape[0]):
        hits = np.nonzero(d2[q] <= radius * radius)[0][:nsample]
        pad = np.full(nsample - len(hits), hits[0] if len(hits) else xyz.shape[0] - 1)
        out[q] = np.concatenate([hits, pad])
    return out


def make_pair(
    src: np.ndarray, seed: int, max_translation: float = 1.0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Native random-pose pair synthesis: (tgt [N,3], R [3,3], t [3])."""
    src = np.ascontiguousarray(src, np.float32)
    lib = _load()
    if lib is not None:
        tgt = np.empty_like(src)
        R = np.empty(9, np.float32)
        t = np.empty(3, np.float32)
        lib.make_pair(src, src.shape[0], seed & (2**64 - 1), max_translation, tgt, R, t)
        return tgt, R.reshape(3, 3), t
    from deepvcp.data.transforms import make_pair as _np_pair

    s, tg, R, t = _np_pair(src, np.random.default_rng(seed),
                           max_translation=max_translation)
    return tg, R, t
