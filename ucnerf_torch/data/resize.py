"""numpy twins of the resizes the JAX package runs through PIL and cv2:
the three of its scene loaders (``ucnerf_tpu/data/scared.py:51-71``) and
the Lanczos of its image pyramids (``ucnerf_tpu/data/llff.py::minify``).

- ``pil_bilinear_u8``: ``PIL.Image.resize(size, BILINEAR)`` of an 8-bit
  RGB image (Pillow's ``ImagingResample``): separable, the triangle filter
  widened by the downscale factor (antialiased), each output's weights
  normalised and rounded to 22-bit fixed point, a horizontal pass over the
  rows the vertical pass reads, a uint8 intermediate, clipped after each
  pass.  Bit for bit.
- ``pil_lanczos_u8``: ``PIL.Image.resize(size, LANCZOS)``, the same passes
  with the Lanczos filter of support 3.  Bit for bit.
- ``cv2_nearest_scale``: ``cv2.resize(d, None, fx=f, fy=f,
  interpolation=cv2.INTER_NEAREST)``: ``src = floor(dst / f)``.  Bit for
  bit.
- ``cv2_linear_f32``: ``cv2.resize(d, (W, H))`` (INTER_LINEAR) of a float
  image: half-pixel centres, no antialias, edges clamped.  Computed in
  float64 and returned as float32, within 1e-6 of cv2's float arithmetic.
"""

from __future__ import annotations

import math

import numpy as np

PRECISION_BITS = 32 - 8 - 2      # Pillow's Resample.c


def _triangle(x: np.ndarray) -> np.ndarray:
    """Pillow's ``bilinear_filter``: 1 - |x| inside (-1, 1), else 0."""
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: np.ndarray) -> np.ndarray:
    """Pillow's ``lanczos_filter``: sinc(x) sinc(x / 3) on [-3, 3), else
    0 (the C library's ``sin``, as the C loop evaluates it)."""
    return np.array([_sinc(v) * _sinc(v / 3.0) if -3.0 <= v < 3.0 else 0.0
                     for v in np.asarray(x, np.float64).ravel()],
                    np.float64).reshape(np.shape(x))


def _pil_coeffs(in_size: int, out_size: int, filt=_triangle,
                support: float = 1.0):
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    filter ``filt`` of ``support`` over the box (0, in_size): (xmin [out],
    xmax [out], k [out, ksize] int64 fixed-point weights)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    ss = 1.0 / filterscale
    # C's (int) truncates toward zero; negatives clamp to 0 right after
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    k = np.zeros((out_size, ksize), np.float64)
    ww = np.zeros(out_size, np.float64)
    for x in range(ksize):
        live = x < xmax
        w = np.where(live, filt(((x + xmin) - center + 0.5) * ss), 0.0)
        k[:, x] = w
        ww = ww + w          # summed in x order, as the C loop does
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0.0, 1.0, ww)[:, None],
                 k)
    fixed = np.where(k < 0, np.trunc(-0.5 + k * (1 << PRECISION_BITS)),
                     np.trunc(0.5 + k * (1 << PRECISION_BITS)))
    return xmin, xmax, fixed.astype(np.int64)


def _clip8(acc: np.ndarray) -> np.ndarray:
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def _pil_pass(img: np.ndarray, axis: int, xmin, xmax, k) -> np.ndarray:
    """One pass along ``axis`` (0 rows, 1 columns) of a uint8 image."""
    a = np.moveaxis(img, axis, 0).astype(np.int64)
    out = np.full((len(xmin),) + a.shape[1:], 1 << (PRECISION_BITS - 1),
                  np.int64)
    for x in range(k.shape[1]):
        live = x < xmax
        idx = np.minimum(xmin + x, a.shape[0] - 1)
        w = np.where(live, k[:, x], 0)
        out += a[idx] * w.reshape((-1,) + (1,) * (a.ndim - 1))
    return np.moveaxis(_clip8(out), 0, axis)


def _pil_resample_u8(img: np.ndarray, size, filt, support: float,
                     name: str) -> np.ndarray:
    """Pillow's ``ImagingResample`` of an 8-bit image [H, W, C] to ``size``
    (w, h): a horizontal pass over the rows the vertical pass reads, a
    uint8 intermediate, then the vertical pass."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"{name} takes [H, W, C] uint8, got "
                         f"{img.shape} {img.dtype}")
    w, h = int(size[0]), int(size[1])
    H, W = img.shape[:2]
    if (w, h) == (W, H):
        return img.copy()
    ymin, ymax, ky = _pil_coeffs(H, h, filt, support)
    out = img
    if w != W:
        # the horizontal pass covers only the rows the vertical pass reads
        first, last = int(ymin[0]), int(ymin[-1] + ymax[-1])
        xmin, xmax, kx = _pil_coeffs(W, w, filt, support)
        out = _pil_pass(img[first:last], 1, xmin, xmax, kx)
        ymin = ymin - first
    if h != H:
        out = _pil_pass(out, 0, ymin, ymax, ky)
    return out


def pil_bilinear_u8(img: np.ndarray, size) -> np.ndarray:
    """[H, W, C] uint8 -> [h, w, C] uint8 as ``Image.resize((w, h),
    BILINEAR)`` with ``reducing_gap=None``.  ``size`` is (w, h)."""
    return _pil_resample_u8(img, size, _triangle, 1.0, "pil_bilinear_u8")


def pil_lanczos_u8(img: np.ndarray, size) -> np.ndarray:
    """[H, W, C] uint8 -> [h, w, C] uint8 as ``Image.resize((w, h),
    LANCZOS)`` with ``reducing_gap=None``: the same fixed-point passes as
    ``pil_bilinear_u8`` with the Lanczos filter of support 3 (negative
    lobes; each pass clips to [0, 255]).  ``size`` is (w, h)."""
    return _pil_resample_u8(img, size, _lanczos, 3.0, "pil_lanczos_u8")


def _nearest(d: np.ndarray, h: int, w: int, inv_y: float, inv_x: float):
    """cv2's ``resizeNN``: ``src = floor(dst * inv)``, clamped."""
    H, W = d.shape[:2]
    sy = np.minimum(np.floor(np.arange(h) * inv_y).astype(np.int64), H - 1)
    sx = np.minimum(np.floor(np.arange(w) * inv_x).astype(np.int64), W - 1)
    return d[sy[:, None], sx[None, :]]


def cv2_nearest_scale(d: np.ndarray, f: float) -> np.ndarray:
    """``cv2.resize(d, None, fx=f, fy=f, INTER_NEAREST)``: the size rounds
    half to even (``saturate_cast<int>``), the source index is ``floor(dst
    * (1 / f))``."""
    d = np.asarray(d)
    H, W = d.shape[:2]
    inv = 1.0 / float(f)
    return _nearest(d, int(np.rint(H * f)), int(np.rint(W * f)), inv, inv)


def cv2_nearest_size(d: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(d, (w, h), INTER_NEAREST)``: the scale is ``out / in``
    and the source index ``floor(dst * (1 / scale))``."""
    d = np.asarray(d)
    H, W = d.shape[:2]
    w, h = int(size[0]), int(size[1])
    return _nearest(d, h, w, 1.0 / (h / H), 1.0 / (w / W))


def _linear_taps(in_size: int, out_size: int):
    f = ((np.arange(out_size, dtype=np.float64) + 0.5) * (in_size / out_size)
         - 0.5)
    s = np.floor(f)
    w = f - s
    s = s.astype(np.int64)
    low, high = s < 0, s >= in_size - 1
    w = np.where(low | high, 0.0, w)
    s = np.where(low, 0, np.where(high, in_size - 1, s))
    return s, np.minimum(s + 1, in_size - 1), w


def cv2_linear_f32(d: np.ndarray, size) -> np.ndarray:
    """[H, W] float -> [h, w] float32 as ``cv2.resize(d, (w, h))``."""
    d = np.asarray(d, np.float64)
    w, h = int(size[0]), int(size[1])
    y0, y1, wy = _linear_taps(d.shape[0], h)
    x0, x1, wx = _linear_taps(d.shape[1], w)
    rows = d[y0] * (1.0 - wy)[:, None] + d[y1] * wy[:, None]
    out = rows[:, x0] * (1.0 - wx)[None, :] + rows[:, x1] * wx[None, :]
    return out.astype(np.float32)
