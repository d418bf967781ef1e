"""Baseline JPEG decoding and encoding through the port's own C++ code.

``csrc/jpeg_decode.cpp`` decodes sequential Huffman, 8-bit, 3-component
YCbCr files (4:4:4, 4:2:2, 4:2:0, restart intervals, any size) to the
pixels PIL gives with libjpeg-turbo's defaults (islow IDCT, fancy
upsampling, libjpeg's YCbCr -> RGB tables).  It builds with the host C++
compiler at first use (``kernels/build.py``); without one, or on a file it
does not read (progressive, arithmetic-coded, 12-bit, grayscale, CMYK) or
cannot decode, ``decode_jpeg`` raises and names the cause.

``csrc/jpeg_encode.cpp`` writes what PIL's ``Image.save(path)`` writes
for an 8-bit RGB image with libjpeg-turbo's defaults (quality 75, 4:2:0,
islow FDCT, standard Huffman tables), built the same way
(``encode_jpeg``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ucnerf_torch.kernels import build

SOI = b"\xff\xd8"
_ERRLEN = 256


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("jpeg_decode")
    lib.ucn_jpeg_size.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                  ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int),
                                  ctypes.c_char_p, ctypes.c_int]
    lib.ucn_jpeg_size.restype = ctypes.c_int
    lib.ucn_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                    ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_char_p,
                                    ctypes.c_int]
    lib.ucn_jpeg_decode.restype = ctypes.c_int
    return lib


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> [H, W, 3] uint8 RGB.  Raises ValueError naming
    ``name`` and the cause for a file the decoder does not read."""
    lib = _lib()
    data = bytes(data)
    err = ctypes.create_string_buffer(_ERRLEN)
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    if lib.ucn_jpeg_size(data, len(data), ctypes.byref(w), ctypes.byref(h),
                         err, _ERRLEN):
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.ucn_jpeg_decode(data, len(data), out.ctypes.data, w.value,
                           h.value, err, _ERRLEN):
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
    return out


@functools.lru_cache(maxsize=None)
def _encoder() -> ctypes.CDLL:
    lib = build.load("jpeg_encode")
    lib.ucn_jpeg_encode.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_longlong,
                                    ctypes.c_char_p, ctypes.c_int]
    lib.ucn_jpeg_encode.restype = ctypes.c_longlong
    return lib


# PIL's default, libjpeg's
QUALITY = 75


def encode_jpeg(img) -> bytes:
    """[H, W, 3] uint8 RGB -> baseline JPEG bytes (PIL's default save)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes [H, W, 3] uint8, got "
                         f"{img.shape} {img.dtype}")
    lib = _encoder()
    err = ctypes.create_string_buffer(_ERRLEN)
    H, W = img.shape[:2]
    cap = 2 * img.size + 4096
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.ucn_jpeg_encode(img.ctypes.data, W, H, QUALITY,
                                out.ctypes.data, cap, err, _ERRLEN)
        if n < 0:
            raise ValueError(err.value.decode(errors="replace"))
        if n <= cap:
            return out[:n].tobytes()
        cap = n


def write_jpeg(path: str, img) -> None:
    with open(path, "wb") as fh:
        fh.write(encode_jpeg(img))


def read_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        return decode_jpeg(fh.read(), str(path))
