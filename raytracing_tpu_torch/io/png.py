"""Minimal dependency-free PNG writer and reader (stdlib zlib), as in
``raytracing_tpu.io.png``, and the reference's u8 tonemap."""
from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data +
            struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(image) -> bytes:
    """image: (H, W, 3) or (H, W, 4) uint8, or float in [0, 1] -> PNG bytes.
    Takes numpy arrays and CPU or CUDA tensors."""
    if hasattr(image, "detach"):
        image = image.detach().cpu().numpy()
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    h, w, c = img.shape
    color_type = {3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    out = b"\x89PNG\r\n\x1a\n"
    out += _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                       0, 0, 0))
    out += _chunk(b"IDAT", zlib.compress(raw, 6))
    out += _chunk(b"IEND", b"")
    return out


def write_png(path: str, image) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image))


def _unfilter(ft: int, line: np.ndarray, prev: np.ndarray, nch: int
              ) -> np.ndarray:
    """One scanline's bytes (int32) after its filter ``ft``: None, Sub, Up
    and Average / Paeth (a byte at a time: each reads its left neighbour's
    result)."""
    if ft == 0:
        return line
    if ft == 2:
        return (line + prev) & 0xFF
    if ft == 1:
        return np.cumsum(line.reshape(-1, nch), 0).reshape(-1) & 0xFF
    cur = np.zeros_like(line)
    for x in range(line.shape[0]):
        a = int(cur[x - nch]) if x >= nch else 0
        b = int(prev[x])
        if ft == 3:
            pred = (a + b) // 2
        else:
            c = int(prev[x - nch]) if x >= nch else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[x] = (int(line[x]) + pred) & 0xFF
    return cur


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader: 8-bit gray / RGB / RGBA, non-interlaced, all
    five scanline filters. Returns (H, W, C) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    idat = b""
    w = h = depth = color = interlace = None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, depth, color, _, _, interlace = struct.unpack(
                ">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    assert depth == 8 and interlace == 0, "read_png: 8-bit non-interlaced only"
    nch = {0: 1, 2: 3, 6: 4}[color]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    stride = w * nch
    rows = raw[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        prev = _unfilter(int(rows[y, 0]), rows[y, 1:].astype(np.int32),
                         prev, nch)
        out[y] = prev
    return out.reshape(h, w, nch)


def tonemap_u8(acc, divisor: float, exposure: float = 1.8) -> np.ndarray:
    """Accumulator (numpy, or a CPU or CUDA tensor) -> u8 image the
    reference way: the mean over samples and passes (``divisor``), times
    ``exposure``, clamped to [0, 1], times 255, truncated."""
    if hasattr(acc, "detach"):
        acc = acc.detach().cpu().numpy()
    img = acc * (exposure / max(divisor, 1e-30))
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
