"""Dependency-free PNG output (the reference displays via OpenGL/GLFW;
headless GPU jobs write files instead — SURVEY.md §2.4). numpy only."""
from __future__ import annotations

import struct
import zlib

import numpy as np


def tonemap(rgb: np.ndarray) -> np.ndarray:
    """Linear [0, inf) float -> uint8 with the GL default framebuffer
    behavior: plain clamp (the reference blits the accumulation average
    straight to an RGBA8 backbuffer with no tone curve)."""
    return (np.clip(np.asarray(rgb), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, rgb: np.ndarray, flip_vertical: bool = True) -> None:
    """rgb: [H, W, 3] float (linear, row 0 = bottom by default) or uint8."""
    a = np.asarray(rgb)
    if a.dtype != np.uint8:
        a = tonemap(a)
    if a.ndim == 2:
        a = np.repeat(a[..., None], 3, axis=-1)
    if flip_vertical:
        a = a[::-1]
    h, w = a.shape[:2]

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(
            ">I", zlib.crc32(c) & 0xFFFFFFFF)

    raw = b"".join(
        b"\x00" + a[y].tobytes() for y in range(h)
    )
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)

