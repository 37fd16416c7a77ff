"""Minimal dependency-free PNG IO (stdlib zlib + struct).

A copy of d3d12_deferred_renderer_tpu/utils/image.py (that package imports
JAX at import); tests/test_torch_io.py pins the two byte for byte.  The
reference's stb_image dependency is dead code (included but never called,
main.cpp:24-25); the renderer needs image IO for golden tests and frame
dumps, so it is implemented here: RGB/RGBA 8-bit, no external deps.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def write_png(path: str, image: np.ndarray) -> None:
    """Write [H, W, 3|4] uint8 (or [H, W] grayscale) as PNG."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError("write_png expects uint8")
    if image.ndim == 2:
        image = image[..., None]
    h, w, c = image.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + image[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit RGB/RGBA/grayscale PNG written by write_png (filter 0 or 1/2/3/4)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a png"
    pos = 8
    idat = b""
    w = h = color_type = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, bit_depth, color_type, comp, filt, interlace = struct.unpack(
                ">IIBBBBB", body[:13]
            )
            if bit_depth != 8:
                raise ValueError("only 8-bit PNGs supported")
            if comp != 0 or filt != 0:
                raise ValueError("unsupported PNG compression/filter method")
            if interlace != 0:
                # Adam7 pass data would decode as scrambled scanlines below.
                raise ValueError("interlaced (Adam7) PNGs are not supported")
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
        pos += 12 + length
    channels = {0: 1, 2: 3, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    stride = w * channels
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    at = 0
    for y in range(h):
        ftype = raw[at]
        row = np.frombuffer(raw[at + 1 : at + 1 + stride], np.uint8).astype(np.int32)
        at += 1 + stride
        if ftype == 0:
            cur = row
        elif ftype == 2:  # up
            cur = (row + prev) & 0xFF
        else:
            cur = np.zeros(stride, np.int32)
            for i in range(stride):
                a = cur[i - channels] if i >= channels else 0
                b = prev[i]
                cc = prev[i - channels] if i >= channels else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) // 2
                elif ftype == 4:
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                else:
                    raise ValueError(f"unsupported filter {ftype}")
                cur[i] = (row[i] + pred) & 0xFF
        out[y] = cur.astype(np.uint8)
        prev = cur
    img = out.reshape(h, w, channels)
    return img[..., 0] if channels == 1 else img
