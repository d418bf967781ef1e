"""The port's DPT-Hybrid (``ucnerf_torch.models.dpt``) against the JAX
package's at full width, with seeded weights under transformers' names
(no published weights are in the repository): on a 64x64 image (the /16
map is 4x4, so the position embeddings resize from 24x24) the trunk, the
depth output and the segmentation logits in f32, and the bf16 trunk
against JAX's bf16 trunk; ``load_dpt`` / ``load_dpt_seg``'s pipelines
around stub nets; ``resize_bicubic`` and ``dpt_input_size``.

Tolerances (f32 on one CPU thread; measured beside each): the trunk and
the logits rel-to-max 1e-4; the depth output, ReLU'd and up to ~80 here,
max abs 2e-3 (2.5e-5 of its max); the bf16 trunk rel-to-max 6e-2 against
JAX's bf16 trunk, the bound ``tests/test_dpt.py`` puts on JAX's bf16 trunk
against its f32 one."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ucnerf_tpu.models import dpt as J
from ucnerf_tpu.ops.interpolate import _cubic_weight_matrix as j_cubic_matrix
from ucnerf_tpu.ops.interpolate import resize_bicubic as j_resize_bicubic

from ucnerf_torch.models import dpt as T
from ucnerf_torch.ops.interpolate import _cubic_weight_matrix, resize_bicubic

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
IMG = np.random.default_rng(8).uniform(-1, 1, (64, 64, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    """Seeded depth and segmentation weights (one trunk) in the JAX
    layouts, as ``convert_dpt_torch_state_dict`` of either package gives
    them."""
    depth = T.seeded_dpt_state_dict(0)
    seg = T.seeded_dpt_state_dict(0, "seg", shared=depth)
    return {"depth": T.convert_dpt_torch_state_dict(depth),
            "seg": T.convert_dpt_torch_state_dict(seg)}


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


def _jax_trunk_and_head(p, head, monkeypatch):
    """JAX's ``_dpt_trunk`` of IMG, then ``head`` (``dpt_forward`` or
    ``dpt_seg_forward`` of the JAX package) on that trunk: the head runs
    with ``_dpt_trunk`` answering the map already computed, so the trunk
    compiles once."""
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    trunk = jax.jit(J._dpt_trunk)(jp, jnp.asarray(IMG))
    with monkeypatch.context() as m:
        m.setattr(J, "_dpt_trunk", lambda p, img: trunk)
        out = jax.jit(lambda p, img: head(p, img))(jp, jnp.asarray(IMG))
    return np.asarray(trunk), np.asarray(out)


def test_dpt_matches_jax(weights, monkeypatch):
    j_trunk, j_depth = _jax_trunk_and_head(weights["depth"], J.dpt_forward,
                                           monkeypatch)
    p = T.to_torch_params(weights["depth"])
    with torch.no_grad():
        fused = T._dpt_trunk(p, _nchw(IMG))
        depth = T._depth_head(p, fused)
    trunk = fused[0].permute(1, 2, 0).numpy()
    assert trunk.shape == (32, 32, T.FUSION)
    assert depth.shape == (1, 64, 64) and depth.dtype == torch.float32
    rel = _rel_to_max(trunk, j_trunk)
    assert rel < 1e-4, rel                                 # measured 1.4e-6
    err = np.abs(depth[0].numpy() - j_depth).max()
    assert err < 2e-3, err                                 # measured 1.4e-4


def test_dpt_seg_matches_jax(weights, monkeypatch):
    j_trunk, want = _jax_trunk_and_head(weights["seg"], J.dpt_seg_forward,
                                        monkeypatch)
    p = T.to_torch_params(weights["seg"])
    with torch.no_grad():
        trunk = T._dpt_trunk(p, _nchw(IMG))
        got = T.dpt_seg_forward(p, _nchw(IMG))[0].permute(1, 2, 0).numpy()
    rel = _rel_to_max(trunk[0].permute(1, 2, 0).numpy(), j_trunk)
    assert rel < 1e-4, rel
    assert got.shape == want.shape == (64, 64, T.ADE20K_LABELS)
    rel = _rel_to_max(got, want)
    assert rel < 1e-4, rel                                 # measured 1.7e-6


def test_dpt_bf16_trunk_matches_jax_bf16(weights):
    """``dtype="bfloat16"``: every float parameter in bf16, norm scales and
    BN running statistics too; the trunk against JAX's bf16 trunk; the
    outputs stay f32."""
    jp = {k: jnp.asarray(v.astype(jnp.bfloat16))
          for k, v in weights["depth"].items()}
    want = np.asarray(jax.jit(J._dpt_trunk)(
        jp, jnp.asarray(IMG, jnp.bfloat16)).astype(jnp.float32))
    p = T.to_torch_params(weights["depth"], "bfloat16")
    assert all(v.dtype == torch.bfloat16 for v in p.values())
    bn = T.to_torch_params({k: v for k, v in weights["seg"].items()
                            if "running" in k or "batch_norm" in k},
                           "bfloat16")
    assert "head.head.1.running_var" in bn and all(
        v.dtype == torch.bfloat16 for v in bn.values())
    x = _nchw(IMG, torch.bfloat16)
    with torch.no_grad():
        got = T._dpt_trunk(p, x)[0].permute(1, 2, 0).float().numpy()
        out = T.dpt_forward(p, x)
    rel = _rel_to_max(got, want)
    assert rel < 6e-2, rel                                 # measured 1.9e-2
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


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
