"""Dependency-free PNG output and input (the reference displays via
OpenGL/GLFW; headless GPU jobs write files instead — SURVEY.md §2.4).
numpy only."""
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



def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for our own files (8-bit RGB, no interlace).
    Returns float32 [H, W, 3] in [0, 1], row 0 = top."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a png"
    pos = 8
    idat = b""
    w = h = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            assert depth == 8 and ctype == 2, "only 8-bit RGB supported"
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * 3
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    p = 0
    for y in range(h):
        filt = raw[p]
        row = np.frombuffer(raw[p + 1:p + 1 + stride], np.uint8).astype(np.int32)
        p += 1 + stride
        if filt == 0:
            cur = row
        elif filt == 1:
            cur = row.copy()
            for i in range(3, stride):
                cur[i] = (cur[i] + cur[i - 3]) & 0xFF
        elif filt == 2:
            cur = (row + prev) & 0xFF
        elif filt == 3:
            cur = row.copy()
            for i in range(stride):
                left = cur[i - 3] if i >= 3 else 0
                cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
        else:  # Paeth
            cur = row.copy()
            for i in range(stride):
                a_ = cur[i - 3] if i >= 3 else 0
                b_ = prev[i]
                c_ = prev[i - 3] if i >= 3 else 0
                pp = a_ + b_ - c_
                pa, pb, pc = abs(pp - a_), abs(pp - b_), abs(pp - c_)
                pred = a_ if (pa <= pb and pa <= pc) else (b_ if pb <= pc else c_)
                cur[i] = (cur[i] + pred) & 0xFF
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out.reshape(h, w, 3).astype(np.float32) / 255.0
