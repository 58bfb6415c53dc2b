"""ctypes bindings of the frame-preparation kernels `native/frame_loader.cpp`
(port of `eggfusion_tpu/native/loader.py`): the undistortion remap and the
metric depth conversion. Numpy in, numpy out; the C++ side splits rows over
threads and the call releases the interpreter lock.
"""
from __future__ import annotations

import ctypes

import numpy as np

from eggfusion_tpu_torch.native import load

_F, _U8, _U16 = ctypes.c_float, ctypes.c_uint8, ctypes.c_uint16
_lib = None


def _get():
    global _lib
    if _lib is None:
        lib = load("frame_loader")
        P = ctypes.POINTER
        lib.ef_remap_u8.restype = None
        lib.ef_remap_u8.argtypes = [P(_U8), ctypes.c_int, ctypes.c_int, ctypes.c_int, P(_F), P(_F), P(_U8)]
        lib.ef_remap_f32.restype = None
        lib.ef_remap_f32.argtypes = [P(_F), ctypes.c_int, ctypes.c_int, ctypes.c_int, P(_F), P(_F), P(_F)]
        lib.ef_depth_convert_u16.restype = None
        lib.ef_depth_convert_u16.argtypes = [P(_U16), ctypes.c_int, ctypes.c_int, P(_F), P(_F),
                                             _F, _F, _F, P(_F)]
        _lib = lib
    return _lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _maps(mapx, mapy, h, w):
    mapx = np.ascontiguousarray(mapx, np.float32)
    mapy = np.ascontiguousarray(mapy, np.float32)
    if mapx.shape != (h, w) or mapy.shape != (h, w):
        raise ValueError(f"remap tables {mapx.shape}, {mapy.shape} do not match the image ({h}, {w})")
    return mapx, mapy


def remap(src: np.ndarray, mapx: np.ndarray, mapy: np.ndarray) -> np.ndarray:
    """Bilinear inverse remap (cv2.remap INTER_LINEAR): output pixel (y, x)
    samples `src` at (mapy, mapx); samples outside the image are 0.

    src: (H, W) or (H, W, C), uint8 (rounded) or float32."""
    lib = _get()
    squeeze = src.ndim == 2
    if squeeze:
        src = src[..., None]
    h, w, c = src.shape
    mapx, mapy = _maps(mapx, mapy, h, w)
    if src.dtype == np.uint8:
        src = np.ascontiguousarray(src)
        dst = np.empty_like(src)
        lib.ef_remap_u8(_ptr(src, _U8), h, w, c, _ptr(mapx, _F), _ptr(mapy, _F), _ptr(dst, _U8))
    else:
        src = np.ascontiguousarray(src, np.float32)
        dst = np.empty_like(src)
        lib.ef_remap_f32(_ptr(src, _F), h, w, c, _ptr(mapx, _F), _ptr(mapy, _F), _ptr(dst, _F))
    return dst[..., 0] if squeeze else dst


def depth_to_metric(raw: np.ndarray, depth_scale: float, mapx: np.ndarray | None = None,
                    mapy: np.ndarray | None = None, min_m: float = 0.0, max_m: float = 1e9) -> np.ndarray:
    """uint16 raw depth -> float32 metres (raw / depth_scale, 0 outside
    [min_m, max_m]), sampled at the nearest source pixel of the remap
    tables when given."""
    lib = _get()
    raw = np.ascontiguousarray(raw, np.uint16)
    h, w = raw.shape
    out = np.empty((h, w), np.float32)
    if mapx is not None:
        mapx, mapy = _maps(mapx, mapy, h, w)
        px, py = _ptr(mapx, _F), _ptr(mapy, _F)
    else:
        px = py = ctypes.cast(None, ctypes.POINTER(_F))
    lib.ef_depth_convert_u16(_ptr(raw, _U16), h, w, px, py, 1.0 / float(depth_scale), float(min_m),
                             float(max_m), _ptr(out, _F))
    return out
