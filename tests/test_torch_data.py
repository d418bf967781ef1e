"""The port's scene datasets against the JAX package's, on the CPU: the JPEG
decoder against PIL, the resize twins against PIL and cv2, COLMAP I/O and
the LLFF poses, every field of every sample of ScaredDataset (JPEG and PNG
frames), HamlynDataset and FinetuneDataset, the scene cache both ways, and
the nearest pyramid (``python -m ucnerf_torch.train --preset
train_hamlyn`` is in ``tests/test_torch_data_hamlyn.py``).

Scenes are fabricated as ``tests/test_scared_pipeline.py`` builds them
(PIL-written frames, COLMAP binaries from ``_make_model``), with GT depth
(16-bit PNG, cv2) and a DPT prior.  Tolerances: bit for bit everywhere but
the DPT prior, whose resize is cv2's float32 INTER_LINEAR and the port's a
float64 twin (max abs <= 1e-6 at values in [0, 5]).
"""

import hashlib
import io
import json
import os
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from test_colmap_io import _make_model
from ucnerf_torch.data import build_dataset
from ucnerf_torch.data import colmap as t_colmap
from ucnerf_torch.data import llff as t_llff
from ucnerf_torch.data.base import (load_colmap_sparse_depth,
                                    make_stage_pyramid)
from ucnerf_torch.data.finetune import FinetuneDataset
from ucnerf_torch.data.resize import (cv2_linear_f32, cv2_nearest_scale,
                                      cv2_nearest_size, pil_bilinear_u8)
from ucnerf_torch.data.scared import HamlynDataset, ScaredDataset
from ucnerf_torch.config import parse_config
from ucnerf_torch.utils.jpeg import decode_jpeg
from ucnerf_tpu.data import colmap as j_colmap
from ucnerf_tpu.data import llff as j_llff
from ucnerf_tpu.data.base import \
    load_colmap_sparse_depth as j_load_colmap_sparse_depth
from ucnerf_tpu.data.base import make_stage_pyramid as j_make_stage_pyramid
from ucnerf_tpu.data.finetune import FinetuneDataset as JFinetuneDataset
from ucnerf_tpu.data.scared import HamlynDataset as JHamlynDataset
from ucnerf_tpu.data.scared import ScaredDataset as JScaredDataset

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parent / "data"
DPT_TOL = 1e-6
KW = dict(n_views=3, n_depth_rays=64, max_train_samples=2)


def _jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil_pixels(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _smooth(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 7.0 + c) * np.cos(y / 5.0 - c)
                    for c in range(3)], -1)
    return np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(np.uint8)


# ------------------------------------------------------------------ JPEG
@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("wh", [(37, 23), (1, 1), (3, 2), (17, 9)])
def test_jpeg_decoder_equals_pil(subsampling, wh):
    """Sizes that are no MCU multiple, chroma planes 1-2 samples wide (box
    upsampling), two qualities, with and without a restart marker after
    every MCU: PIL's pixels bit for bit."""
    w, h = wh
    img = _smooth(h, w, w * h + subsampling)
    for kw in (dict(quality=90), dict(quality=50, restart_marker_blocks=1)):
        data = _jpeg(img, subsampling=subsampling, **kw)
        assert (b"\xff\xdd" in data) == ("restart_marker_blocks" in kw)
        np.testing.assert_array_equal(decode_jpeg(data), _pil_pixels(data))


def test_jpeg_fixtures_and_full_size():
    """The committed fixtures decode to the digests recorded beside them
    (PIL's pixels) and to PIL's pixels here; a fresh 1280x1024 frame at
    each sampling layout equals PIL's."""
    record = json.loads((FIXTURES / "jpeg_fixtures.json").read_text())
    assert (sum((FIXTURES / n).stat().st_size for n in record)
            <= 200 * 1024)
    for name, want in record.items():
        data = (FIXTURES / name).read_bytes()
        got = decode_jpeg(data, name)
        assert got.shape == (want["height"], want["width"], 3)
        assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]
        np.testing.assert_array_equal(got, _pil_pixels(data))
    img = _smooth(1024, 1280, 3)
    for ss in (0, 1, 2):
        data = _jpeg(img, quality=85, subsampling=ss)
        np.testing.assert_array_equal(decode_jpeg(data), _pil_pixels(data))


def test_jpeg_refuses_what_it_does_not_read():
    """Progressive, grayscale and CMYK frames, a truncated file and a
    non-JPEG each raise, naming the file and the cause."""
    img = _smooth(23, 37, 0)
    cmyk = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(cmyk, "JPEG")
    whole = _jpeg(img)
    cut = whole[:(whole.index(b"\xff\xda") + len(whole)) // 2]  # mid-scan
    cases = {
        "prog.jpg": (_jpeg(img, progressive=True), "progressive"),
        "gray.jpg": (_jpeg(img[..., 0]), "grayscale"),
        "cmyk.jpg": (cmyk.getvalue(), "CMYK"),
        "cut.jpg": (cut, "ends early"),
        "png.jpg": (b"\x89PNG\r\n\x1a\n", "not a JPEG"),
    }
    for name, (data, cause) in cases.items():
        with pytest.raises(ValueError, match=f"{name}.*{cause}"):
            decode_jpeg(data, name)


def test_no_compiler_raises(monkeypatch):
    """Without a host C++ compiler the decoder's build raises and says so;
    nothing falls back."""
    from ucnerf_torch.kernels import build

    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        build.find_cxx()


# ------------------------------------------------------------------ resizes
SIZES = [((1280, 1024), (320, 256)), ((64, 48), (320, 256)),
         ((320, 256), (160, 128))]


@pytest.mark.parametrize("src,dst", SIZES, ids=lambda s: "x".join(map(str, s)))
def test_resize_twins(src, dst):
    """PIL BILINEAR and cv2 INTER_NEAREST (by fx = fy = w/W, as the GT
    depth is resized, and by size, as the pyramid is) bit for bit, cv2
    INTER_LINEAR within DPT_TOL."""
    rng = np.random.default_rng(src[0])
    (W, H), (w, h) = src, dst
    img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        pil_bilinear_u8(img, dst),
        np.asarray(Image.fromarray(img).resize(dst, Image.BILINEAR)))
    d = rng.integers(0, 60000, (H, W)).astype(np.float32) * 1e-3
    f = w / W
    want = cv2.resize(d, None, fx=f, fy=f, interpolation=cv2.INTER_NEAREST)
    got = cv2_nearest_scale(d, f)
    assert got.shape == want.shape and got.shape[1] == w
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        cv2_nearest_size(d, dst),
        cv2.resize(d, dst, interpolation=cv2.INTER_NEAREST))
    p = rng.uniform(0.0, 5.0, (H, W)).astype(np.float32)
    got = cv2_linear_f32(p, dst)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, cv2.resize(p, dst), rtol=0, atol=DPT_TOL)


def test_stage_pyramid_follows_cv2_nearest():
    """At 50x70 neither /4 nor /2 divides the width; the pyramid is cv2's
    INTER_NEAREST (the JAX package's), not a stride."""
    img = np.random.default_rng(0).uniform(size=(50, 70)).astype(np.float32)
    got, want = make_stage_pyramid(img), j_make_stage_pyramid(img)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------------------ scenes
def _write_scene(root: Path, seed: int, ext: str, frame_wh, n_images,
                 png_frames=False):
    """A SCARED-layout scan: frames (``ext``), 16-bit mm GT depth, DPT
    npz priors at another size, ``sparse/0`` and ``poses_bounds.npy``."""
    rng = np.random.default_rng(seed)
    os.makedirs(root / "sparse" / "0")
    for sub in ("images", "depths", "dpt"):
        os.makedirs(root / sub)
    cams, images, points = _make_model(rng, n_images=n_images, n_points=300)
    j_colmap.write_cameras_binary(cams, root / "sparse/0/cameras.bin")
    j_colmap.write_images_binary(images, root / "sparse/0/images.bin")
    j_colmap.write_points3d_binary(points, root / "sparse/0/points3D.bin")
    W, H = frame_wh
    for i in range(1, n_images + 1):
        stem = f"img_{i:03d}"
        arr = _smooth(H, W, seed + i)
        if png_frames:
            Image.fromarray(arr).save(root / "images" / f"{stem}.png")
        else:
            Image.fromarray(arr).save(root / "images" / f"{stem}.{ext}",
                                      quality=90)
        # SCARED: 16-bit millimetres; Hamlyn (no scaling): 8-bit units
        depth = (rng.integers(1000, 9000, (H, W)).astype(np.uint16)
                 if ext == "jpeg" else
                 rng.integers(1, 90, (H, W)).astype(np.uint8))
        cv2.imwrite(str(root / "depths" / f"{stem}.png"), depth)
        pred = rng.uniform(0.0, 5.0, (1, H // 2 + 3, W // 2 + 5))
        # the loaders find the prior at the frame's name with "jpeg"
        # swapped for "npz": next to a PNG frame that name ends in .png
        with open(root / "dpt" / f"{stem}.{'png' if png_frames else 'npz'}",
                  "wb") as fh:
            np.savez(fh, pred=pred.astype(np.float32))
    j_llff.gen_poses(str(root))


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    base = tmp_path_factory.mktemp("scenes")
    out = {}
    for name, ext, wh, n, png in (("scared", "jpeg", (160, 128), 8, False),
                                  ("scared_png", "jpeg", (64, 48), 8, True),
                                  ("hamlyn", "jpg", (320, 256), 6, False)):
        _write_scene(base / name / "scene0", 7 + len(out), ext, wh, n,
                     png_frames=png)
        out[name] = str(base / name)
    ini = base / "scared" / "scene0" / "index.ini"
    ini.write_text("[index]\ntrain = 0,2,4,6\ntest = 1,5\n")
    return out


def _cache(root):
    return os.path.join(root, "scene0", "_ucnerf_cache.npz")


def _fresh(cls, root, split, **kw):
    """A dataset built with no scene cache on disk (a cold load)."""
    if os.path.exists(_cache(root)):
        os.remove(_cache(root))
    return cls(root, split=split, **KW, **kw)


def _assert_samples_equal(a, b, where=""):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_samples_equal(a[k], b[k], f"{where}{k}/")
        elif k == "dpt":
            assert a[k].shape == b[k].shape
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=DPT_TOL,
                                       err_msg=where + k)
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=where + k)


CASES = {
    "scared_jpeg": ("scared", ScaredDataset, JScaredDataset, {}),
    "scared_png": ("scared_png", ScaredDataset, JScaredDataset, {}),
    "hamlyn_half": ("hamlyn", HamlynDataset, JHamlynDataset,
                    dict(downsample=0.5)),
    "finetune": ("scared", FinetuneDataset, JFinetuneDataset, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_dataset_samples_equal_jax(scenes, case):
    """Every field of every sample of the train and val splits, each
    package decoding the scan itself (its train split loads cold and
    writes the cache its val split then reads): bit for bit, DPT within
    DPT_TOL.  GT depth and the DPT prior are present (not zeros)."""
    key, cls, jcls, kw = CASES[case]
    root = scenes[key]
    ours = {"train": _fresh(cls, root, "train", **kw)}
    ours["val"] = cls(root, split="val", **KW, **kw)
    theirs = {"train": _fresh(jcls, root, "train", **kw)}
    theirs["val"] = jcls(root, split="val", **KW, **kw)
    for split in ("train", "val"):
        a_ds, b_ds = ours[split], theirs[split]
        assert a_ds.metas == b_ds.metas and len(a_ds) > 0
        assert a_ds.img_wh == b_ds.img_wh
        for i in range(len(a_ds)):
            a_ds.set_epoch(1)
            b_ds.set_epoch(1)
            a, b = a_ds[i], b_ds[i]
            assert a["depths_h"].any() and a["dpt"].any()
            _assert_samples_equal(a, b, f"{case}/{split}/{i}/")
    if case == "hamlyn_half":
        assert ours["val"].img_wh == (160, 128)
    if case == "finetune":
        assert [m[1] for m in ours["val"].metas] == [1, 5]


def test_scene_cache_shared_with_jax(scenes, monkeypatch):
    """The key strings are equal; a cache the JAX package wrote loads in the
    port without a rebuild and one the port wrote loads in the JAX package;
    a stale key (another downsample, a touched source) rebuilds."""
    root = scenes["scared"]
    key = _fresh(ScaredDataset, root, "val")._cache_key("scene0")
    theirs = _fresh(JScaredDataset, root, "val")
    assert key == theirs._cache_key("scene0")
    assert str(np.load(_cache(root))["cache_key"]) == key

    def no_rebuild(self, scan):
        raise AssertionError("rebuilt a scene the cache holds")

    # the cache on disk is the JAX package's: the port loads it
    monkeypatch.setattr(ScaredDataset, "_load_scene_uncached", no_rebuild)
    warm = ScaredDataset(root, split="val", **KW)
    for k in ("images", "depths", "dpt", "c2ws", "w2cs", "intrinsic",
              "near_far", "bounds"):
        np.testing.assert_array_equal(warm.scene["scene0"][k],
                                      theirs.scene["scene0"][k], err_msg=k)
    monkeypatch.undo()
    # the port writes it; the JAX package loads it
    _fresh(ScaredDataset, root, "val")
    monkeypatch.setattr(JScaredDataset, "_load_scene_uncached", no_rebuild)
    JScaredDataset(root, split="val", **KW)
    monkeypatch.undo()
    # stale keys rebuild in the port
    calls = []
    rebuild = ScaredDataset._load_scene_uncached
    monkeypatch.setattr(ScaredDataset, "_load_scene_uncached",
                        lambda self, scan: calls.append(scan)
                        or rebuild(self, scan))
    ds = ScaredDataset(root, split="val", downsample=0.125, **KW)
    assert calls == ["scene0"] and ds.img_wh == (160, 128)
    pb = os.path.join(root, "scene0", "poses_bounds.npy")
    st = os.stat(pb)
    os.utime(pb, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    ScaredDataset(root, split="val", downsample=0.125, **KW)
    assert calls == ["scene0", "scene0"]
    ScaredDataset(root, split="val", downsample=0.125, **KW)
    assert calls == ["scene0", "scene0"]


# ------------------------------------------------------------ COLMAP, poses
def _assert_models_equal(a, b):
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            for f in x[k]._fields:
                u, v = getattr(x[k], f), getattr(y[k], f)
                if isinstance(u, np.ndarray):
                    np.testing.assert_array_equal(u, v)
                else:
                    assert u == v


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_colmap_io_and_poses_equal_jax(tmp_path, ext):
    """Each package reads the model the other wrote; ``gen_poses``,
    ``prepare_scene_poses`` and the sparse-depth splat equal the JAX
    package's bit for bit."""
    model = _make_model(np.random.default_rng(3), n_images=5, n_points=150)
    for writer, name in ((t_colmap, "t"), (j_colmap, "j")):
        d = tmp_path / name / "sparse" / "0"
        writer.write_model(*model, str(d), ext=ext)
        assert t_colmap.detect_model_format(str(d)) == ext
        _assert_models_equal(t_colmap.read_model(str(d)),
                             j_colmap.read_model(str(d)))
    R = t_colmap.qvec2rotmat(model[1][2].qvec)
    np.testing.assert_array_equal(t_colmap.rotmat2qvec(R),
                                  j_colmap.rotmat2qvec(R))
    if ext == ".txt":
        return
    scene = str(tmp_path / "t")
    ours = t_llff.gen_poses(scene, str(tmp_path / "pb_t.npy"))
    np.testing.assert_array_equal(ours, j_llff.gen_poses(
        scene, str(tmp_path / "pb_j.npy")))
    pb = str(tmp_path / "pb_t.npy")
    a = t_llff.prepare_scene_poses(pb, (320, 256))
    b = j_llff.prepare_scene_poses(pb, (320, 256))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    _, bds = t_llff.load_poses_bounds(pb)
    ours = load_colmap_sparse_depth(scene, (320, 256), 0.25, bds)
    theirs = j_load_colmap_sparse_depth(scene, (320, 256), 0.25, bds)
    assert len(ours) == len(theirs) == 5
    assert sum(len(e["coords"]) for e in ours) > 0
    for e, f in zip(ours, theirs):
        assert sorted(e) == sorted(f)
        for k in e:
            np.testing.assert_array_equal(e[k], f[k], err_msg=k)


# ------------------------------------------------------------------ CLI
def test_presets_reach_a_dataset(scenes):
    """Every preset a user runs builds its dataset in the port."""
    for preset, key, scale in (("train_scared", "scared", "0.125"),
                               ("eval_scared", "scared", "0.125"),
                               ("train_hamlyn", "hamlyn", "0.5"),
                               ("eval_hamlyn", "hamlyn", "0.5")):
        cfg = parse_config(["--preset", preset, "--datadir", scenes[key],
                            "--view_num", "3", "--imgScale_test", scale,
                            "--samples_per_scene", "1"])
        ds = build_dataset(cfg, "val")
        assert ds.metas and type(ds).__name__.lower().startswith(
            cfg.dataset_name)

