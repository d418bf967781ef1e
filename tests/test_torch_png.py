"""ucnerf_torch.utils.png against PIL: PIL decodes the port's PNGs to the
exact arrays, and ``decode_png`` decodes PIL's (and files with each of the
five row filters) to the exact arrays."""

import io
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from ucnerf_torch.utils.png import (decode_png, encode_png, read_png,
                                    write_png)

torch.set_num_threads(1)


def _images():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:29, 0:37]
    smooth = np.stack([xx * 7, yy * 9, (xx + yy) * 3], -1) % 256
    return {
        "rgb_noise": rng.integers(0, 256, (23, 31, 3), dtype=np.uint8),
        "rgb_smooth": smooth.astype(np.uint8),
        "gray16_noise": rng.integers(0, 65536, (17, 13), dtype=np.uint16),
        "gray16_ramp": (yy * 2000 + xx * 37).astype(np.uint16),
    }


def _pil_decode(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


@pytest.mark.parametrize("name", sorted(_images()))
def test_pil_reads_ours_and_we_read_pils(name, tmp_path):
    img = _images()[name]
    path = str(tmp_path / "a.png")
    write_png(path, img)
    np.testing.assert_array_equal(_pil_decode(open(path, "rb").read()), img)
    np.testing.assert_array_equal(read_png(path), img)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="png")
    got = decode_png(buf.getvalue())
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)


def _filtered_png(img: np.ndarray, bpp: int) -> bytes:
    """A PNG whose row y carries filter type y % 5, filtered as the PNG
    specification defines each type, split over two IDAT chunks."""
    H = img.shape[0]
    rows = (img.astype(">u2") if img.dtype == np.uint16 else img)
    rows = rows.reshape(H, -1).view(np.uint8).astype(np.int64)
    prior = np.zeros(rows.shape[1], np.int64)
    out = []
    for y, cur in enumerate(rows):
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        p = left + prior - upleft
        pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prior, upleft))
        pred = [0, left, prior, (left + prior) // 2, paeth][y % 5]
        out.append(np.concatenate([[y % 5], (cur - pred) % 256]))
        prior = cur
    data = zlib.compress(np.concatenate(out).astype(np.uint8).tobytes())
    depth, ctype = (16, 0) if img.dtype == np.uint16 else (8, 2)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    half = len(data) // 2
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", img.shape[1], H, depth,
                                         ctype, 0, 0, 0))
            + chunk(b"IDAT", data[:half]) + chunk(b"IDAT", data[half:])
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("name", ["rgb_noise", "gray16_noise"])
def test_all_five_row_filters(name):
    img = _images()[name]
    data = _filtered_png(img, 3 if img.ndim == 3 else 2)
    np.testing.assert_array_equal(_pil_decode(data), img)   # a valid file
    np.testing.assert_array_equal(decode_png(data), img)


@pytest.mark.parametrize("mode", ["RGBA", "L"])
def test_we_read_pils_rgba_and_gray8(mode):
    """The two types only ``decode_png`` reads (dataset frames may be RGBA,
    depth maps 8-bit gray): PIL's files, adaptive row filters and all."""
    rng = np.random.default_rng(1)
    shape = (19, 27, 4) if mode == "RGBA" else (19, 27)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, format="png")
    got = decode_png(buf.getvalue())
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, img)


def test_refuses_other_types_and_damage():
    with pytest.raises(ValueError, match="uint8"):
        encode_png(np.zeros((4, 4), np.uint8))
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4, 2), np.uint8), "LA").save(buf,
                                                             format="png")
    with pytest.raises(ValueError, match="colour type 4"):
        decode_png(buf.getvalue())
    data = bytearray(encode_png(np.zeros((4, 5, 3), np.uint8)))
    data[40] ^= 1                       # inside the IDAT chunk
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(data))
    with pytest.raises(ValueError, match="signature"):
        decode_png(b"GIF89a" + bytes(20))
