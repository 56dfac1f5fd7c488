"""Copy of parallel_ray_tracer_tpu/utils/bmp.py (numpy only).

BMP output: 32bpp BGRA, BITMAPINFOHEADER, bottom-up rows.

Byte-compatible with the reference writer (cpu/src/bmp_writer.c:88-146,
gpu/src/bmp_writer.cu:8-47): float [0,1] -> byte via *255 truncation toward
zero after clamping, alpha 255, rows written bottom-up.
"""

from __future__ import annotations

import struct

import numpy as np


def bmp_bytes(image: np.ndarray) -> bytes:
    """image: (H, W, 3) float in [0,1] or uint8. Returns full BMP file bytes."""
    h, w = image.shape[:2]
    if image.dtype != np.uint8:
        arr = np.clip(image, 0.0, 1.0)
        arr = (arr * 255.0).astype(np.uint8)  # C float->uchar cast truncates
    else:
        arr = image

    # BGRA, bottom-up (cpu/src/bmp_writer.c:131-143).
    bgra = np.empty((h, w, 4), np.uint8)
    bgra[..., 0] = arr[..., 2]
    bgra[..., 1] = arr[..., 1]
    bgra[..., 2] = arr[..., 0]
    bgra[..., 3] = 255
    bgra = bgra[::-1]  # bottom-up row order

    pixel_bytes = bgra.tobytes()
    # BITMAPFILEHEADER (14) + BITMAPINFOHEADER (40).
    file_size = 14 + 40 + len(pixel_bytes)
    header = struct.pack("<2sIHHI", b"BM", file_size, 0, 0, 54)
    info = struct.pack(
        "<IiiHHIIiiII",
        40,          # biSize
        w,           # biWidth
        h,           # biHeight (positive: bottom-up)
        1,           # biPlanes
        32,          # biBitCount
        0,           # BI_RGB
        len(pixel_bytes),
        2835,        # ~72 DPI
        2835,
        0,
        0,
    )
    return header + info + pixel_bytes


def write_bmp(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(bmp_bytes(image))


def read_bmp(path: str) -> np.ndarray:
    """Read a 32bpp (or 24bpp) uncompressed BMP -> (H, W, 3) uint8 RGB.

    Enough to load the reference binary's output and our own for comparison.
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")
    (offset,) = struct.unpack_from("<I", data, 10)
    (hsize,) = struct.unpack_from("<I", data, 14)
    w, h = struct.unpack_from("<ii", data, 18)
    (bpp,) = struct.unpack_from("<H", data, 28)
    flip = h > 0
    h = abs(h)
    if bpp == 32:
        raw = np.frombuffer(data, np.uint8, h * w * 4, offset).reshape(h, w, 4)
        rgb = raw[..., [2, 1, 0]]
    elif bpp == 24:
        stride = (w * 3 + 3) & ~3
        raw = np.frombuffer(data, np.uint8, h * stride, offset).reshape(h, stride)
        raw = raw[:, : w * 3].reshape(h, w, 3)
        rgb = raw[..., [2, 1, 0]]
    else:
        raise ValueError(f"unsupported bpp {bpp}")
    if flip:
        rgb = rgb[::-1]
    return np.ascontiguousarray(rgb)
