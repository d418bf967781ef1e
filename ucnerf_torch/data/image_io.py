"""Frames and depth maps of the scene datasets, without cv2 or PIL.

``read_frame`` gives the 8-bit RGB frame PIL opens (the JAX loaders read
frames with ``PIL.Image.open``), dispatched on the file's magic bytes: JPEG
through the port's decoder (``utils/jpeg.py``), PNG through
``utils/png.py``.  ``read_depth_png`` gives what ``cv2.imread(path,
cv2.IMREAD_UNCHANGED)`` gives for a gray PNG: uint16 or uint8 [H, W].
Anything else raises and names the file.
"""

from __future__ import annotations

import numpy as np

from ucnerf_torch.utils.jpeg import SOI, decode_jpeg
from ucnerf_torch.utils.png import SIGNATURE, decode_png


def _read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def read_frame(path: str) -> np.ndarray:
    """[H, W, 3] uint8 RGB of a JPEG or PNG frame.

    An RGBA PNG gives its RGB planes when every pixel is opaque: PIL
    resizes RGBA with premultiplied alpha, which equals resizing the RGB
    planes only where alpha is 255 throughout.  Gray frames raise (the JAX
    loader cannot read them either: ``[..., :3]`` of a 2-D array slices
    columns)."""
    data = _read(path)
    if data[:2] == SOI:
        return decode_jpeg(data, str(path))
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: neither JPEG nor PNG")
    img = decode_png(data)
    if img.ndim == 3 and img.shape[2] == 3:
        return img
    if img.ndim == 3 and img.shape[2] == 4:
        if not (img[..., 3] == 255).all():
            raise ValueError(f"{path}: RGBA frame with transparent pixels "
                             "(PIL resizes those premultiplied; not read)")
        return np.ascontiguousarray(img[..., :3])
    raise ValueError(f"{path}: a frame must be RGB or RGBA, got gray "
                     f"{img.dtype} {img.shape}")


def read_depth_png(path: str) -> np.ndarray:
    """[H, W] uint16 or uint8 of a 16- or 8-bit gray PNG depth map."""
    data = _read(path)
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: a depth map must be a PNG file")
    d = decode_png(data)
    if d.ndim != 2:
        raise ValueError(f"{path}: a depth map must be gray, got {d.shape}")
    return d
