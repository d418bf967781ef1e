"""``python -m ucnerf_torch.convert_weights`` against the JAX package's
``convert_weights.py``: for each of the five kinds, the npz the port writes
equals the JAX CLI's for the same seeded input, key for key, dtype for
dtype and bit for bit; the DPT inputs come as a torch file, a
``from_pretrained`` directory and a ``{'state_dict': ...}`` wrapper; the
port's loaders read what either package wrote."""

import numpy as np
import pytest
import torch

import convert_weights as j_convert
from ucnerf_tpu.utils import checkpoint_io as j_ckpt

from ucnerf_torch import convert_weights
from ucnerf_torch.config import parse_config
from ucnerf_torch.eval.lpips import load_lpips, seeded_lpips_state_dict
from ucnerf_torch.models import dpt
from ucnerf_torch.models.factory import init_params
from ucnerf_torch.utils import checkpoint_io

from test_torch_checkpoints import _reference_files
from test_torch_train import ARGS

torch.set_num_threads(1)


def _assert_same_npz(got_path, want_path):
    with np.load(got_path) as got, np.load(want_path) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        return {k: got[k] for k in got.files}


def _both(kind, src, tmp_path):
    """(the port's npz, the JAX CLI's npz) of ``kind`` from ``src``."""
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "jax.npz")
    assert convert_weights.main([kind, str(src), ours]) == ours
    assert j_convert.main([kind, str(src), theirs]) == theirs
    return ours, theirs


@pytest.mark.parametrize("kind", ["ucnerf", "casmvsnet"])
def test_reference_checkpoints(kind, tmp_path):
    cfg = parse_config(ARGS)
    trained = init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    tar, ckpt = _reference_files(
        tmp_path, checkpoint_io.jax_params_from_state_dict(trained))
    ours, theirs = _both(kind, tar if kind == "ucnerf" else ckpt, tmp_path)
    got = _assert_same_npz(ours, theirs)
    assert {k.split("/")[0] for k in got} == (
        {"nerf", "mvs"} if kind == "ucnerf" else {"mvs"})
    # --ckpt of the port reads it as the weights it came from
    params = checkpoint_io.load_params(cfg.replace(ckpt=ours), "cpu")
    for k, v in trained["mvs"].items():
        assert torch.equal(torch.as_tensor(params["mvs"][k]),
                           torch.as_tensor(v)), k


def test_casmvsnet_without_a_cascade_is_refused(tmp_path, monkeypatch):
    for mod in (checkpoint_io, j_ckpt):
        monkeypatch.setattr(mod, "convert_reference_checkpoint",
                            lambda path: {"nerf": {}})
    for cli in (convert_weights, j_convert):
        with pytest.raises(ValueError, match="not a casmvsnet checkpoint"):
            cli.main(["casmvsnet", "x.ckpt", str(tmp_path / "o.npz")])


def test_lpips(tmp_path):
    src = tmp_path / "lpips_alex.pth"
    torch.save({k: torch.from_numpy(v)
                for k, v in seeded_lpips_state_dict(0).items()}, src)
    ours, theirs = _both("lpips", src, tmp_path)
    got = _assert_same_npz(ours, theirs)
    assert sorted(got) == sorted(f"{p}{i}_{s}" for i in range(5)
                                 for p, s in (("conv", "w"), ("conv", "b"),
                                              ("lin", "w")))
    rng = np.random.default_rng(6)
    a, b = (rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
            for _ in range(2))
    fn = load_lpips(ours)
    assert np.isfinite(fn(a, b)) and fn(a, b) > 0 and fn(a, a) == 0


def _small_dpt_state_dict(task):
    """transformers' names, dtypes and ranks, each side cut to 4: the
    conversion transposes by rank and name, so widths do not matter."""
    return {k: torch.from_numpy(dpt._seeded_array(
                k, tuple(min(d, 4) for d in s), 1))
            for k, s in dpt.dpt_state_dict_shapes(task).items()}


@pytest.mark.parametrize("kind,form", [("dpt", "file"),
                                       ("dpt_seg", "directory"),
                                       ("dpt", "wrapped")])
def test_dpt(kind, form, tmp_path):
    sd = _small_dpt_state_dict("seg" if kind == "dpt_seg" else "depth")
    if form == "file":
        src = tmp_path / "dpt_hybrid.bin"
        torch.save(sd, src)
    elif form == "directory":
        src = tmp_path / "dpt-hybrid-ade"
        src.mkdir()
        torch.save(sd, src / "pytorch_model.bin")
    else:
        src = tmp_path / "dpt_hybrid.pth"
        torch.save({"state_dict": sd}, src)
    ours, theirs = _both(kind, src, tmp_path)
    got = _assert_same_npz(ours, theirs)
    assert list(got) == list(sd)                     # state-dict order
    assert all(v.dtype == np.float32 for v in got.values())
    # the port's loader reads the npz (JAX layouts) and the torch file
    # into the same tensors in torch layouts
    from_npz = dpt._load_converted_params(ours, "UNSET", "unset")
    if form == "file":
        from_bin = dpt._load_converted_params(str(src), "UNSET", "unset")
        for k in sd:
            assert torch.equal(from_npz[k], from_bin[k]), k
    w = "dpt.embeddings.backbone.bit.embedder.convolution.weight"
    assert from_npz[w].shape == sd[w].shape
    assert torch.allclose(from_npz[w].mean(dim=(1, 2, 3)),
                          torch.zeros(sd[w].shape[0]), atol=1e-6)
    head = "head.head.4.weight"
    assert torch.equal(from_npz[head], sd[head].float())


def test_missing_model_file_in_a_directory(tmp_path):
    with pytest.raises(FileNotFoundError, match="pytorch_model.bin"):
        convert_weights.main(["dpt", str(tmp_path), str(tmp_path / "o.npz")])
