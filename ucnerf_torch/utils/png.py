"""PNG files with ``zlib`` alone.

The card's machine has no image library, so frames, validation panels and
the datasets' PNG frames and depth maps go through this module.
``encode_png`` writes 8-bit RGB and 16-bit gray as one IDAT chunk of
unfiltered rows, non-interlaced.  ``decode_png`` reads 8-bit RGB, 8-bit
RGBA, 8-bit gray and 16-bit gray as any encoder writes them: any number
of IDAT chunks and all five row filters (None, Sub, Up, Average, Paeth).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (bit depth, colour type) -> (channels, numpy dtype of a sample)
_TYPES = {(8, 2): (3, np.dtype(np.uint8)), (16, 0): (1, np.dtype(">u2")),
          (8, 6): (4, np.dtype(np.uint8)), (8, 0): (1, np.dtype(np.uint8))}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def encode_png(img) -> bytes:
    """[H, W, 3] uint8 (RGB) or [H, W] uint16 (gray) -> PNG bytes."""
    a = np.asarray(img)
    if a.ndim == 3 and a.shape[2] == 3 and a.dtype == np.uint8:
        depth, ctype = 8, 2
    elif a.ndim == 2 and a.dtype == np.uint16:
        depth, ctype = 16, 0
    else:
        raise ValueError(f"encode_png takes [H, W, 3] uint8 or [H, W] "
                         f"uint16, got {a.shape} {a.dtype}")
    H, W = a.shape[:2]
    dtype = _TYPES[depth, ctype][1]
    rows = np.ascontiguousarray(a, dtype=dtype).reshape(H, -1)
    raw = np.concatenate([np.zeros((H, 1), np.uint8),   # filter 0 per row
                          rows.view(np.uint8)], axis=1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype,
                                          0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img) -> None:
    with open(path, "wb") as fh:
        fh.write(encode_png(img))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, H: int, stride: int, bpp: int) -> np.ndarray:
    """Filtered scanlines [H, 1 + stride] -> the image bytes [H, stride]."""
    out = np.zeros((H, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(H):
        ftype, line = raw[y, 0], raw[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:     # Sub: a running sum per byte of the pixel
            cur = (np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint64)
                   % 256).astype(np.uint8).reshape(-1)
        elif ftype == 2:     # Up
            cur = line + prior
        elif ftype in (3, 4):
            x, b = line.tolist(), prior.tolist()
            for i in range(stride):
                left = x[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (left + b[i]) >> 1
                else:
                    pred = _paeth(left, b[i], b[i - bpp] if i >= bpp else 0)
                x[i] = (x[i] + pred) & 0xFF
            cur = np.asarray(x, np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ftype}")
        out[y] = prior = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, 3] uint8 (8-bit RGB), [H, W, 4] uint8 (8-bit
    RGBA), [H, W] uint8 (8-bit gray) or [H, W] uint16 (16-bit gray).  Other
    colour types, bit depths and interlaced files raise."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos, header, idat = 8, None, []
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(body) != n or zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: truncated or bad CRC")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG file without IHDR or IDAT")
    W, H, depth, ctype, _, _, interlace = header
    if (depth, ctype) not in _TYPES or interlace:
        raise ValueError(f"decode_png reads 8-bit RGB, RGBA and gray and "
                         f"16-bit gray, non-interlaced; got bit depth "
                         f"{depth}, colour type {ctype}, interlace "
                         f"{interlace}")
    channels, dtype = _TYPES[depth, ctype]
    bpp = channels * dtype.itemsize
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (1 + W * bpp):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected "
                         f"{H * (1 + W * bpp)}")
    img = _unfilter(raw.reshape(H, 1 + W * bpp), H, W * bpp, bpp)
    img = img.view(dtype).astype(dtype.newbyteorder("="))
    return img.reshape(H, W, channels) if channels > 1 else img.reshape(H, W)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        return decode_png(fh.read())
