"""ucnerf_torch's image pyramids (``data/llff.py::minify``) against the JAX
package's, which resizes and writes through PIL: the Lanczos twin
(``data/resize.py::pil_lanczos_u8``) against PIL's LANCZOS bit for bit,
and a scene of PNG frames and one of JPEG frames minified by both
packages (the JPEG files by ``csrc/jpeg_encode.cpp``, which this machine
builds with its host compiler)."""

import io
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from ucnerf_tpu.data.llff import minify as j_minify

from ucnerf_torch.data.llff import minify
from ucnerf_torch.data.resize import pil_lanczos_u8

torch.set_num_threads(1)

FRAMES = 4
FRAME_WH = (101, 75)         # odd sizes: partial MCUs, a rounded factor
FACTORS = (2, 3)
RESOLUTIONS = ((40, 30),)


def _frame(rng, w, h) -> np.ndarray:
    """A smooth image with noise and an edge: the Lanczos lobes ring and
    clip, and the DCT sees both flat and busy blocks."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    base = np.stack([128 + 100 * np.sin(x / 7 + k) * np.cos(y / 5 - k)
                     for k in range(3)], -1)
    base[:, w // 2:] = 255 - base[:, w // 2:]
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(
        np.uint8)


def test_lanczos_matches_pil_bit_for_bit():
    rng = np.random.default_rng(0)
    for (H, W), (w, h) in (((75, 101), (51, 38)), ((64, 96), (32, 21)),
                           ((37, 53), (80, 60)), ((17, 17), (5, 9)),
                           ((1024, 1280), (640, 512))):
        img = (_frame(rng, W, H) if H < 100 else
               rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
        want = np.asarray(Image.fromarray(img).resize((w, h),
                                                      Image.LANCZOS))
        np.testing.assert_array_equal(pil_lanczos_u8(img, (w, h)), want,
                                      err_msg=f"{(H, W)} -> {(w, h)}")


def _scene(root, ext: str) -> str:
    rng = np.random.default_rng(1)
    scene = os.path.join(root, "scene")
    os.makedirs(os.path.join(scene, "images"))
    for i in range(FRAMES):
        Image.fromarray(_frame(rng, *FRAME_WH)).save(
            os.path.join(scene, "images", f"{i:06d}{ext}"))
    return scene


@pytest.mark.parametrize("ext", [".png", ".jpg"])
def test_minify_matches_the_jax_package(tmp_path, ext):
    """Both packages minify copies of one scene (factors 2 and 3, one
    explicit size): the same directories and files, each decoding by PIL
    to the same pixels; the JPEG files are PIL's byte for byte too."""
    scene = _scene(str(tmp_path / "port"), ext)
    jscene = str(tmp_path / "jax" / "scene")
    shutil.copytree(scene, jscene)
    dirs = minify(scene, FACTORS, RESOLUTIONS)
    jdirs = j_minify(jscene, FACTORS, RESOLUTIONS)
    assert [os.path.basename(d) for d in dirs] == [
        os.path.basename(d) for d in jdirs] == ["images_2", "images_3",
                                                "images_40x30"]
    for d, jd in zip(dirs, jdirs):
        names = sorted(os.listdir(d))
        assert names == sorted(os.listdir(jd)) and len(names) == FRAMES
        for n in names:
            with open(os.path.join(d, n), "rb") as fh:
                got = fh.read()
            with open(os.path.join(jd, n), "rb") as fh:
                want = fh.read()
            px = np.asarray(Image.open(io.BytesIO(got)))
            np.testing.assert_array_equal(
                px, np.asarray(Image.open(io.BytesIO(want))),
                err_msg=f"{d}/{n}")
            if ext == ".jpg":
                assert got == want, f"{d}/{n}: bytes differ from PIL's"
    # a frame already written is kept, as in the JAX package
    assert minify(scene, FACTORS, RESOLUTIONS) == dirs
