"""Validation panels and segmentation overlays: the port of
``ucnerf_tpu/utils/viz.py`` (``visualize_depth``, ``save_val_panel``,
``ADE20K_PALETTE``, ``blend_segmentation``) without matplotlib or cv2.

``JET`` is matplotlib's ``jet`` colormap as its 256-entry lookup table,
built from jet's segment data as ``LinearSegmentedColormap`` builds it, so
``visualize_depth`` equals the JAX package's bit for bit.  The panel's
title strips are left blank: the JAX package draws the titles with
``cv2.putText``, and no font is drawn here.
"""

from __future__ import annotations

import os

import numpy as np

from ucnerf_torch.utils.png import write_png

# matplotlib's ``_cm._jet_data``: per channel (x, y below x, y above x)
_JET_SEGMENTS = (
    ((0.00, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.00, 0.5, 0.5)),
    ((0.000, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.640, 1, 1),
     (0.910, 0, 0), (1.000, 0, 0)),
    ((0.00, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
     (1.00, 0, 0)),
)
N_COLORS = 256
STRIP, PAD = 22, 4       # title strip height and padding, in pixels


def _lookup_table(segments, n: int) -> np.ndarray:
    """matplotlib's ``colors._create_lookup_table`` at gamma 1."""
    a = np.array(segments, dtype=float)
    x, y0, y1 = a[:, 0] * (n - 1), a[:, 1], a[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]],
                          distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                          [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


JET = np.stack([_lookup_table(s, N_COLORS) for s in _JET_SEGMENTS], axis=-1)


def visualize_depth(depth, minmax=None) -> np.ndarray:
    """Depth [H, W] -> uint8 RGB through jet.  The range runs from the
    least positive value (invalid pixels are 0) to the largest; NaN reads
    as 0."""
    x = np.nan_to_num(np.asarray(depth, np.float32))
    if minmax is None:
        mi = np.min(x[x > 0]) if (x > 0).any() else 0.0
        ma = np.max(x)
    else:
        mi, ma = minmax
    x = np.clip((x - mi) / (ma - mi + 1e-8), 0, 1)
    # matplotlib's Colormap.__call__ on floats in [0, 1]: x * N truncated,
    # with x == 1 on the last entry
    idx = x * N_COLORS
    idx[idx == N_COLORS] = N_COLORS - 1
    return (JET[idx.astype(int)] * 255).astype(np.uint8)


def _to_u8(img) -> np.ndarray:
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0, 1) * 255).astype(np.uint8)
    if a.ndim == 2:
        a = np.repeat(a[..., None], 3, axis=-1)
    return a


def val_panel(gt_rgb, pred_rgb, gt_depth, pred_depth) -> np.ndarray:
    """The 2x2 panel [2 (STRIP + H) + PAD, 2 W + PAD, 3] uint8: GT and
    rendered RGB above GT and rendered depth, each tile under a white
    title strip, white padding between them."""
    tiles = [_to_u8(gt_rgb), _to_u8(pred_rgb), visualize_depth(gt_depth),
             visualize_depth(pred_depth)]
    H, W = tiles[0].shape[:2]
    panel = np.full((2 * (STRIP + H) + PAD, 2 * W + PAD, 3), 255, np.uint8)
    for i, t in enumerate(tiles):
        top = (i // 2) * (STRIP + H + PAD) + STRIP
        left = (i % 2) * (W + PAD)
        panel[top:top + H, left:left + W] = t
    return panel


def save_val_panel(path: str, gt_rgb, pred_rgb, gt_depth, pred_depth):
    """``val_panel`` written as an 8-bit RGB PNG at ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, val_panel(gt_rgb, pred_rgb, gt_depth, pred_depth))


# ADE20K mask palette (label 0 = black background, labels 1..150), the
# standard table the reference's seg runner paints with
# (``preprocess/DPT/util/pallete.py`` -> Hang Zhang's PyTorch-Encoding,
# MIT license) — a spec constant, flat [R,G,B, R,G,B, ...].
ADE20K_PALETTE = np.array([
    0, 0, 0, 120, 120, 120, 180, 120, 120, 6, 230, 230, 80, 50, 50, 4, 200,
    3, 120, 120, 80, 140, 140, 140, 204, 5, 255, 230, 230, 230, 4, 250, 7,
    224, 5, 255, 235, 255, 7, 150, 5, 61, 120, 120, 70, 8, 255, 51, 255, 6,
    82, 143, 255, 140, 204, 255, 4, 255, 51, 7, 204, 70, 3, 0, 102, 200, 61,
    230, 250, 255, 6, 51, 11, 102, 255, 255, 7, 71, 255, 9, 224, 9, 7, 230,
    220, 220, 220, 255, 9, 92, 112, 9, 255, 8, 255, 214, 7, 255, 224, 255,
    184, 6, 10, 255, 71, 255, 41, 10, 7, 255, 255, 224, 255, 8, 102, 8, 255,
    255, 61, 6, 255, 194, 7, 255, 122, 8, 0, 255, 20, 255, 8, 41, 255, 5,
    153, 6, 51, 255, 235, 12, 255, 160, 150, 20, 0, 163, 255, 140, 140, 140,
    250, 10, 15, 20, 255, 0, 31, 255, 0, 255, 31, 0, 255, 224, 0, 153, 255,
    0, 0, 0, 255, 255, 71, 0, 0, 235, 255, 0, 173, 255, 31, 0, 255, 11, 200,
    200, 255, 82, 0, 0, 255, 245, 0, 61, 255, 0, 255, 112, 0, 255, 133, 255,
    0, 0, 255, 163, 0, 255, 102, 0, 194, 255, 0, 0, 143, 255, 51, 255, 0, 0,
    82, 255, 0, 255, 41, 0, 255, 173, 10, 0, 255, 173, 255, 0, 0, 255, 153,
    255, 92, 0, 255, 0, 255, 255, 0, 245, 255, 0, 102, 255, 173, 0, 255, 0,
    20, 255, 184, 184, 0, 31, 255, 0, 255, 61, 0, 71, 255, 255, 0, 204, 0,
    255, 194, 0, 255, 82, 0, 10, 255, 0, 112, 255, 51, 0, 255, 0, 194, 255,
    0, 122, 255, 0, 255, 163, 255, 153, 0, 0, 255, 10, 255, 112, 0, 143,
    255, 0, 82, 0, 255, 163, 255, 0, 255, 235, 0, 8, 184, 170, 133, 0, 255,
    0, 255, 92, 184, 0, 255, 255, 0, 31, 0, 184, 255, 0, 214, 255, 255, 0,
    112, 92, 255, 0, 0, 224, 255, 112, 224, 255, 70, 184, 160, 163, 0, 255,
    153, 0, 255, 71, 255, 0, 255, 0, 163, 255, 204, 0, 255, 0, 143, 0, 255,
    235, 133, 255, 0, 255, 0, 235, 245, 0, 255, 255, 0, 122, 255, 245, 0,
    10, 190, 212, 214, 255, 0, 0, 204, 255, 20, 0, 255, 255, 255, 0, 0, 153,
    255, 0, 41, 255, 0, 255, 204, 41, 0, 255, 41, 255, 0, 173, 0, 255, 0,
    245, 255, 71, 0, 255, 122, 0, 255, 0, 255, 184, 0, 92, 255, 184, 255, 0,
    0, 133, 255, 255, 214, 0, 25, 194, 194, 102, 255, 0, 92, 0, 255],
    dtype=np.uint8).reshape(-1, 3)


def blend_segmentation(img01, labels, alpha: float = 0.5):
    """ADE20K-palette mask alpha-blended over the image (reference
    ``write_segm_img``, ``preprocess/DPT/util/io.py:201-218``:
    ``Image.blend(img, palette_mask, alpha)``).  img01 [H, W, 3] in [0, 1];
    labels [H, W] ints (1-based ADE20K ids).  Returns uint8 [H, W, 3]."""
    colors = ADE20K_PALETTE[
        np.clip(np.asarray(labels), 0, len(ADE20K_PALETTE) - 1)]
    img = np.asarray(img01, np.float32) * 255.0
    out = img * (1.0 - alpha) + colors.astype(np.float32) * alpha
    return np.clip(out, 0, 255).astype(np.uint8)
