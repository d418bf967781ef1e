"""The port's DPT-Hybrid (``ucnerf_torch.models.dpt``) beside the JAX
package's: the seeded state dicts' layout, ``load_dpt`` /
``load_dpt_seg``'s pipelines around stub nets, ``resize_bicubic`` and
``dpt_input_size`` (the full-width nets against JAX's are in
``tests/test_torch_dpt_jax.py``)."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ucnerf_tpu.models import dpt as J
from ucnerf_tpu.ops.interpolate import _cubic_weight_matrix as j_cubic_matrix
from ucnerf_tpu.ops.interpolate import resize_bicubic as j_resize_bicubic

from ucnerf_torch.models import dpt as T
from ucnerf_torch.ops.interpolate import _cubic_weight_matrix, resize_bicubic

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
IMG = np.random.default_rng(8).uniform(-1, 1, (64, 64, 3)).astype(np.float32)
# compile time, not run time, dominates these references on the CPU
JIT_QUICK = {"xla_backend_optimization_level": 0}


def _nchw(img, dtype=torch.float32):
    return torch.from_numpy(img).permute(2, 0, 1)[None].to(dtype)


def _rel_to_max(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_seeded_state_dicts_have_transformers_layout():
    """Names, shapes, dtypes and order of transformers' hybrid models, as
    ``tests/data/make_dpt_keys.py`` recorded them (entries, parameters,
    and the SHA-256 of the listing "name (shape) dtype" per line)."""
    want = json.loads((ROOT / "tests" / "data" /
                       "dpt_hybrid_state_dicts.json").read_text())
    for task in ("depth", "seg"):
        shapes = T.dpt_state_dict_shapes(task)
        # each entry's dtype as the seeded state dict draws it
        dtypes = {k: T._seeded_array(k, (1,) * len(s), 0).dtype
                  for k, s in shapes.items()}
        text = "".join(f"{k} {tuple(s)} {dtypes[k]}\n"
                       for k, s in shapes.items())
        got = {"entries": len(shapes),
               "parameters": int(sum(np.prod(s) for s in shapes.values())),
               "sha256": hashlib.sha256(text.encode()).hexdigest()}
        assert got == want[task], task
    with pytest.raises(ValueError, match="neither"):
        T.dpt_state_dict_shapes("normals")


def _stub_nets(monkeypatch):
    """Cheap nets in place of DPT, the same function in both packages, and
    a fixed net input size, so that the pipelines around the net (bicubic
    to the net's size, normalization, the net's dtype, the metric
    conversion, bicubic back, argmax + 1) are compared alone."""
    size = lambda h, w, target=384, multiple=32: (64, 96)
    for mod in (J, T):
        monkeypatch.setattr(mod, "dpt_input_size", size)
    monkeypatch.setattr(J, "dpt_forward", lambda p, x: (
        jnp.mean(x.astype(jnp.float32), -1) * 40.0 + 60.0))
    monkeypatch.setattr(T, "dpt_forward", lambda p, x: (
        x.float().mean(1) * 40.0 + 60.0))

    def j_seg(p, x):
        x = x.astype(jnp.float32)
        return jnp.concatenate([x, -x, x[..., :1] * x[..., 1:2]], -1)

    def t_seg(p, x):
        x = x.float()
        return torch.cat([x, -x, x[:, :1] * x[:, 1:2]], 1)

    monkeypatch.setattr(J, "dpt_seg_forward", j_seg)
    monkeypatch.setattr(T, "dpt_seg_forward", t_seg)


@pytest.mark.parametrize("task,dtype", [("depth", None),
                                        ("depth", "bfloat16"),
                                        ("seg", None)])
def test_predict_pipelines_match_jax(task, dtype, tmp_path, monkeypatch):
    _stub_nets(monkeypatch)
    w = str(tmp_path / "w.npz")
    np.savez(w, **{"head.head.4.bias": np.ones(1, np.float32)})
    img = np.random.default_rng(3).uniform(0, 1, (48, 56, 3)).astype(
        np.float32)
    if task == "depth":
        got = T.load_dpt(w, dtype=dtype, device="cpu")(img)
        want = J.load_dpt(w, dtype=dtype)(img)
        assert got.shape == want.shape == (48, 56) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        return
    labels, logits = T.load_dpt_seg(w, device="cpu")(img)
    j_labels, j_logits = J.load_dpt_seg(w)(img)
    assert labels.dtype == np.int32 and labels.shape == (48, 56)
    np.testing.assert_array_equal(labels, j_labels)
    np.testing.assert_allclose(logits, j_logits, rtol=1e-5, atol=1e-5)


def test_weights_found_through_the_environment(tmp_path, monkeypatch):
    """No file at the default path raises and names the converter; the
    environment variable's file is read instead."""
    monkeypatch.chdir(tmp_path)
    for load in (T.load_dpt, T.load_dpt_seg):
        with pytest.raises(FileNotFoundError, match="convert_weights"):
            load(device="cpu")
    w = tmp_path / "elsewhere.npz"
    np.savez(w, **{"dpt.embeddings.cls_token": np.ones((1, 1, 3),
                                                        np.float32)})
    monkeypatch.setenv("UCNERF_DPT_WEIGHTS", str(w))
    monkeypatch.setenv("UCNERF_DPT_SEG_WEIGHTS", str(w))
    for load in (T.load_dpt, T.load_dpt_seg):
        assert callable(load(device="cpu"))


@pytest.mark.parametrize("layout", ["hwc", "hw"])
def test_resize_bicubic_matches_jax(layout):
    """Up and down, on [H, W, C] and on [H, W] (``h_axis=-2,
    w_axis=-1``): the matrices bit for bit, the products within f32
    round-off."""
    rng = np.random.default_rng(5)
    shape = (37, 53, 3) if layout == "hwc" else (37, 53)
    axes = {} if layout == "hwc" else dict(h_axis=-2, w_axis=-1)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    for out in ((64, 96), (20, 30), (37, 30)):
        for n_in, n_out in zip(shape, out):
            np.testing.assert_array_equal(_cubic_weight_matrix(n_in, n_out),
                                          j_cubic_matrix(n_in, n_out))
        got = resize_bicubic(torch.from_numpy(x), out, **axes).numpy()
        want = np.asarray(j_resize_bicubic(jnp.asarray(x), out, **axes))
        assert got.shape == want.shape == out + shape[2:]
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_dpt_input_size_matches_jax():
    """The sizes of ``tests/test_dpt.py``'s reference checks, toward 480
    (segmentation) and 384 (depth)."""
    for target, sizes in (
            (480, [(256, 320), (1024, 1280), (480, 480), (375, 500),
                   (300, 400), (123, 457)]),
            (384, [(256, 320), (1024, 1280), (384, 384), (375, 500),
                   (480, 640), (300, 400), (1080, 1920), (123, 457)])):
        for h, w in sizes:
            assert T.dpt_input_size(h, w, target=target) == \
                J.dpt_input_size(h, w, target=target), (target, h, w)
    assert T.dpt_input_size(1024, 1280) == (384, 480)
