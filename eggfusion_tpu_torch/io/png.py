"""PNG files without Pillow or OpenCV: the images of the RGB-D datasets.

`read_png` reads 8-bit gray, RGB and RGBA and 16-bit gray, non-interlaced,
as numpy arrays shaped as Pillow's `np.array(Image.open(path))` gives them:
(H, W) uint8 or uint16, (H, W, 3) or (H, W, 4) uint8. It checks every
chunk's CRC and undoes all five row filters, in C++
(`native/png_unfilter.cpp`, built at first use). `write_png` writes the same
kinds, every row unfiltered. The colour of Replica, ScanNet++ and Azure
Kinect is JPEG, which the datasets read with Pillow.
"""
from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from eggfusion_tpu_torch.native import load

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 6: 4}  # PNG colour type -> channels: gray, RGB, RGBA
_lib = None


def _unfilter_lib():
    global _lib
    if _lib is None:
        lib = load("png_unfilter")
        P = ctypes.POINTER(ctypes.c_uint8)
        lib.ef_png_unfilter.restype = ctypes.c_int
        lib.ef_png_unfilter.argtypes = [P, ctypes.c_int, ctypes.c_int, ctypes.c_int, P]
        _lib = lib
    return _lib


def _chunks(data: bytes, path):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4 or zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: corrupt PNG chunk {kind!r} at byte {pos}")
        yield kind, body
        pos += 12 + length


def read_png(path) -> np.ndarray:
    """The image in `path` (see the module docstring for the kinds)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif not kind[0] & 0x20:  # an unknown critical chunk (PLTE: palette images)
            raise ValueError(f"{path}: unsupported PNG chunk {kind!r}")
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, compression, filtering, interlace = header
    if color not in CHANNELS or (depth, color) not in ((8, 0), (8, 2), (8, 6), (16, 0)) \
            or compression or filtering or interlace:
        raise ValueError(f"{path}: unsupported PNG ({depth}-bit, colour type {color}, interlace {interlace}): "
                         "8-bit gray / RGB / RGBA and 16-bit gray, not interlaced, are read")
    bpp = CHANNELS[color] * depth // 8
    rowbytes = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (rowbytes + 1):
        raise ValueError(f"{path}: {len(raw)} bytes of image data, expected {h * (rowbytes + 1)}")
    src = np.frombuffer(raw, np.uint8)
    out = np.empty((h, rowbytes), np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    bad = _unfilter_lib().ef_png_unfilter(src.ctypes.data_as(u8), h, rowbytes, bpp, out.ctypes.data_as(u8))
    if bad:
        raise ValueError(f"{path}: unknown filter type in row {bad - 1}")
    if depth == 16:
        return out.view(">u2").astype(np.uint16).reshape(h, w)
    return out.reshape(h, w) if color == 0 else out.reshape(h, w, CHANNELS[color])


def write_png(path, img: np.ndarray, level: int = 6) -> None:
    """Write (H, W) uint8 or uint16 gray, or (H, W, 3 | 4) uint8 RGB(A)."""
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        depth, color, rows = 16, 0, img.astype(">u2").view(np.uint8)
    elif img.dtype == np.uint8 and (img.ndim == 2 or (img.ndim == 3 and img.shape[2] in (3, 4))):
        depth, color = 8, 0 if img.ndim == 2 else {3: 2, 4: 6}[img.shape[2]]
        rows = img
    else:
        raise ValueError(f"write_png takes (H, W) uint8 / uint16 or (H, W, 3 | 4) uint8, got "
                         f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(rows).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)  # filter type 0 on every row

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    with open(path, "wb") as f:
        f.write(SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + chunk(b"IEND", b""))
