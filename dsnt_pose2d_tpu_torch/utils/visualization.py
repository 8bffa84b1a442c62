"""Skeleton renders for pose debugging (port of
``dsnt_pose2d_tpu/utils/visualization.py``).

Pure-numpy drawing: the 16-joint MPII skeleton over an image, used by the
Trainer's sample dumps.  :func:`save_png` writes an 8-bit RGB PNG with the
standard library (``zlib``, ``struct``), so it needs no imaging package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# MPII skeleton edges (joint index pairs).
SKELETON = (
    (0, 1), (1, 2), (2, 6), (3, 6), (3, 4), (4, 5),      # legs
    (6, 7), (7, 8), (8, 9),                               # spine/head
    (10, 11), (11, 12), (12, 7), (13, 7), (13, 14), (14, 15),  # arms
)

_COLORS = np.asarray([
    [255, 80, 80], [255, 160, 80], [255, 255, 80], [160, 255, 80],
    [80, 255, 80], [80, 255, 160], [80, 255, 255], [80, 160, 255],
    [80, 80, 255], [160, 80, 255], [255, 80, 255], [255, 80, 160],
    [200, 200, 200], [255, 200, 120], [120, 200, 255], [200, 255, 120],
], np.uint8)


def _draw_line(img, x0, y0, x1, y1, color):
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) * 2
    xs = np.linspace(x0, x1, n).round().astype(int)
    ys = np.linspace(y0, y1, n).round().astype(int)
    h, w = img.shape[:2]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def _draw_dot(img, x, y, color, r=2):
    h, w = img.shape[:2]
    x, y = int(round(x)), int(round(y))
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dx * dx + dy * dy <= r * r and 0 <= y + dy < h and 0 <= x + dx < w:
                img[y + dy, x + dx] = color


def render_skeleton(image: np.ndarray, coords_px: np.ndarray,
                    mask: np.ndarray | None = None) -> np.ndarray:
    """Overlay the skeleton on an (H, W, 3) image; coords in pixel (x, y).
    A float image in [0, 1] is converted to uint8 first; the result is a new
    uint8 array."""
    img = np.array(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    mask = np.ones(len(coords_px)) if mask is None else np.asarray(mask)
    for a, b in SKELETON:
        if mask[a] > 0 and mask[b] > 0:
            _draw_line(img, coords_px[a, 0], coords_px[a, 1],
                       coords_px[b, 0], coords_px[b, 1], _COLORS[a])
    for j, (x, y) in enumerate(np.asarray(coords_px)):
        if mask[j] > 0:
            _draw_dot(img, x, y, _COLORS[j])
    return img


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def save_png(image: np.ndarray, path: str):
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG (no filtering)."""
    img = np.ascontiguousarray(image)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    # Each scanline starts with its filter type, 0 (none).
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, 3 * w)],
                         axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))
