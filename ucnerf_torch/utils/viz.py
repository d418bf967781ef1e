"""Validation panels: the port of ``ucnerf_tpu/utils/viz.py``
(``visualize_depth``, ``save_val_panel``) without matplotlib or cv2.

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
