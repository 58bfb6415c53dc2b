"""ctypes bindings of the sparse frontend `native/sparse_frontend.cpp`
(port of `eggfusion_tpu/native/sparse.py`). Numpy in, numpy out:

  detect(gray)                      -> (keypoints (n, 3) f32, desc (n, 4) u64)
  track(kp0, d0, kp1, d1, depths,   -> (4x4 delta cam0 -> cam1, inliers)
        fx, fy, cx, cy, ...)           or (None, 0)
"""
from __future__ import annotations

import ctypes

import numpy as np

from eggfusion_tpu_torch.native import load

_F, _U8, _U64 = ctypes.c_float, ctypes.c_uint8, ctypes.c_uint64
_lib = None


def _get():
    global _lib
    if _lib is None:
        lib = load("sparse_frontend")
        P = ctypes.POINTER
        lib.ef_detect.restype = ctypes.c_int
        lib.ef_detect.argtypes = [P(_U8), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  P(_F), P(_U64)]
        lib.ef_track.restype = ctypes.c_int
        lib.ef_track.argtypes = [
            P(_F), P(_U64), ctypes.c_int,
            P(_F), P(_U64), ctypes.c_int,
            P(_F), P(_F), ctypes.c_int, ctypes.c_int,
            _F, _F, _F, _F,
            ctypes.c_int, _F,
            P(_F),
        ]
        _lib = lib
    return _lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def detect(gray: np.ndarray, threshold: int = 20, max_kp: int = 1500):
    """FAST corners and oriented 256-bit descriptors of a (H, W) uint8 image."""
    lib = _get()
    gray = np.ascontiguousarray(gray, np.uint8)
    h, w = gray.shape
    kps = np.empty((max_kp, 3), np.float32)
    desc = np.empty((max_kp, 4), np.uint64)
    n = lib.ef_detect(_ptr(gray, _U8), h, w, threshold, max_kp, _ptr(kps, _F), _ptr(desc, _U64))
    return kps[:n].copy(), desc[:n].copy()


def track(kp0, d0, kp1, d1, depth0, depth1, fx, fy, cx, cy,
          min_inliers: int = 15, inlier_thresh: float = 0.05):
    """Robust SE(3) delta (cam0 coordinates -> cam1) by descriptor matching
    and 3D-3D RANSAC, with its inlier count; (None, 0) when it fails."""
    lib = _get()
    kp0 = np.ascontiguousarray(kp0, np.float32)
    kp1 = np.ascontiguousarray(kp1, np.float32)
    d0 = np.ascontiguousarray(d0, np.uint64)
    d1 = np.ascontiguousarray(d1, np.uint64)
    depth0 = np.ascontiguousarray(depth0, np.float32)
    depth1 = np.ascontiguousarray(depth1, np.float32)
    h, w = depth0.shape
    delta = np.empty(16, np.float32)
    n = lib.ef_track(
        _ptr(kp0, _F), _ptr(d0, _U64), len(kp0),
        _ptr(kp1, _F), _ptr(d1, _U64), len(kp1),
        _ptr(depth0, _F), _ptr(depth1, _F), h, w,
        float(fx), float(fy), float(cx), float(cy),
        int(min_inliers), float(inlier_thresh),
        _ptr(delta, _F),
    )
    if n <= 0:
        return None, 0
    return delta.reshape(4, 4).copy(), int(n)
