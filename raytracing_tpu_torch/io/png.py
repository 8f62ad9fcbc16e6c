"""Minimal dependency-free PNG writer (stdlib zlib), as in
``raytracing_tpu.io.png``."""
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
