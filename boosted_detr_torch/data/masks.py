"""Host-side COCO segmentation rasterization (polygon + RLE) -> dense masks.

A copy of boosted_detr_tpu/data/masks.py:29-139 (numpy only; the port
imports nothing of the JAX package): ``rasterize_polygons`` (even-odd
scanline fill at the pixel centres, rings OR-ed together),
``decode_rle`` (uncompressed and compressed COCO RLE, column-major),
``resize_mask`` (nearest neighbour), ``segmentation_to_mask`` and
``box_to_mask``. The masks are data-pipeline outputs, consumed on the
device as [B, O, S, S] float32 targets by ``models.panoptic.mask_loss``.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np


def rasterize_polygons(polygons: Sequence[Sequence[float]],
                       mask_size: int) -> np.ndarray:
    """Normalized COCO polygons -> [S, S] float32 mask (union of rings).

    Each polygon is a flat [x1, y1, x2, y2, ...] ring with coordinates in
    [0, 1] (normalize pixel-space COCO polygons by image width/height first).
    Even-odd fill evaluated at pixel centers.
    """
    s = mask_size
    out = np.zeros((s, s), np.float32)
    centers = (np.arange(s, dtype=np.float64) + 0.5) / s
    for ring in polygons:
        pts = np.asarray(ring, np.float64).reshape(-1, 2)
        if len(pts) < 3:
            continue
        x0, y0 = pts[:, 0], pts[:, 1]
        x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
        # edges crossing each pixel-row's scanline (half-open in y so shared
        # vertices count once)
        cross = (y0[None, :] <= centers[:, None]) != (
            y1[None, :] <= centers[:, None])  # [S, E]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (centers[:, None] - y0[None, :]) / (y1 - y0)[None, :]
        xi = x0[None, :] + t * (x1 - x0)[None, :]  # [S, E]
        xi = np.where(cross, xi, -np.inf)  # non-crossing edges never count
        # inside(r, c): odd number of edge intersections right of the pixel
        cnt = (xi[:, None, :] >= centers[None, :, None]).sum(axis=-1)
        out = np.maximum(out, (cnt % 2).astype(np.float32))
    return out


def _decode_rle_counts(counts_str: str) -> List[int]:
    """COCO compressed-RLE ASCII counts -> run lengths (public format used by
    pycocotools: base-48 chars carrying 5 bits + continuation, delta-coded)."""
    counts: List[int] = []
    i = 0
    n = len(counts_str)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = ord(counts_str[i]) - 48
            i += 1
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def decode_rle(rle: dict) -> np.ndarray:
    """COCO RLE dict (compressed or uncompressed) -> [H, W] float32 mask."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        if isinstance(counts, bytes):
            counts = counts.decode("ascii")
        counts = _decode_rle_counts(counts)
    counts = np.asarray(counts, np.int64)
    if int(counts.sum()) != h * w:
        raise ValueError(
            f"malformed RLE: counts sum to {int(counts.sum())}, "
            f"expected h*w = {h * w}")
    flat = np.zeros(h * w, np.float32)
    # runs alternate value 0/1 starting with 0, in column-major order
    ends = np.cumsum(counts)
    starts = ends - counts
    for i in range(1, len(counts), 2):
        flat[starts[i]:ends[i]] = 1.0
    return flat.reshape(w, h).T  # Fortran order


def resize_mask(mask: np.ndarray, mask_size: int) -> np.ndarray:
    """Nearest-neighbor [H, W] -> [S, S] (binary-preserving)."""
    h, w = mask.shape
    ri = np.minimum((np.arange(mask_size) + 0.5) * h // mask_size,
                    h - 1).astype(np.int64)
    ci = np.minimum((np.arange(mask_size) + 0.5) * w // mask_size,
                    w - 1).astype(np.int64)
    return mask[ri[:, None], ci[None, :]]


def segmentation_to_mask(segmentation: Any, mask_size: int,
                         bbox: Optional[Sequence[float]] = None
                         ) -> np.ndarray:
    """One COCO ``segmentation`` entry (normalized polygons, an RLE dict, or
    None) -> [S, S] float32. Falls back to a filled normalized box when the
    object has no usable segmentation."""
    if isinstance(segmentation, dict) and "counts" in segmentation:
        return resize_mask(decode_rle(segmentation), mask_size)
    if isinstance(segmentation, (list, tuple)) and len(segmentation):
        return rasterize_polygons(segmentation, mask_size)
    if bbox is not None:
        return box_to_mask(bbox, mask_size)
    return np.zeros((mask_size, mask_size), np.float32)


def box_to_mask(bbox: Sequence[float], mask_size: int) -> np.ndarray:
    """Normalized [x, y, w, h] -> filled-rectangle [S, S] mask (the host
    analogue of models.panoptic.masks_from_boxes)."""
    s = mask_size
    centers = (np.arange(s, dtype=np.float64) + 0.5) / s
    x, y, w, h = bbox[:4]
    inside_y = (centers >= y) & (centers < y + h)
    inside_x = (centers >= x) & (centers < x + w)
    return (inside_y[:, None] & inside_x[None, :]).astype(np.float32)
