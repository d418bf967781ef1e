"""The port's checkpoints and device scene store against the JAX package:
native checkpoints round-trip weights, Adam's moments and step bit for
bit and prune with ``keep``; their ``params.npz`` is the JAX params tree;
reference ``ucnerf.tar`` / ``casmvsnet.ckpt`` files load equal to JAX's
``convert_reference_checkpoint``; a JAX orbax checkpoint reaches the
port through ``scripts/export_params_npz.py``; ``gather_batch`` equals
``SceneDataset.__getitem__`` bit for bit; the cascade's weights carried
from the JAX tree equal the JAX package's export to reference naming."""

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from ucnerf_tpu.models.factory import init_params as j_init_params
from ucnerf_tpu.train.loop import TrainState as JTrainState
from ucnerf_tpu.utils import checkpoint_io as j_ckpt
from ucnerf_tpu.utils.checkpoint_io import export_casmvsnet_state_dict

from ucnerf_torch.config import Config, parse_config
from ucnerf_torch.data import build_dataset
from ucnerf_torch.data.device_store import (build_store, gather_batch,
                                            sample_indices, store_nbytes)
from ucnerf_torch.models.factory import create_models, init_params
from ucnerf_torch.render.serving import to_device_batch
from ucnerf_torch.train.loop import TrainState, make_optimizer
from ucnerf_torch.utils import checkpoint_io
from ucnerf_torch.utils.checkpoint_io import (jax_params_from_state_dict,
                                              mvs_state_dict_from_jax,
                                              state_dict_from_jax)

from test_torch_train import ARGS, H, W, _jcfg

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _state(cfg, seed, mvs_only=False):
    """A TrainState from seeded weights with Adam's moments filled by two
    updates of random gradients."""
    nerf, mvs = create_models(cfg, "cpu", init_params(
        cfg, torch.Generator().manual_seed(seed), "cpu"))
    state = TrainState(nerf, mvs, make_optimizer(cfg, nerf, mvs), step=7,
                       objective="mvs_only" if mvs_only else "full")
    gen = torch.Generator().manual_seed(seed + 100)
    for _ in range(2):
        for group in state.optimizer.param_groups:
            for p in group["params"]:
                p.grad = torch.randn(p.shape, generator=gen)
        state.optimizer.step()
    return state


def _assert_states_equal(a: TrainState, b: TrainState):
    for ma, mb in ((a.nerf, b.nerf), (a.mvs, b.mvs)):
        sa, sb = ma.state_dict(), mb.state_dict()
        assert sorted(sa) == sorted(sb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sorted(oa["state"]) == sorted(ob["state"])
    for i in oa["state"]:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(oa["state"][i][k], ob["state"][i][k]), (i, k)
    assert a.step == b.step


def test_native_checkpoint_round_trip_and_keep(tmp_path):
    cfg = parse_config(ARGS)
    saved = _state(cfg, 0)
    path = checkpoint_io.save_checkpoint(str(tmp_path), saved, 7)
    assert sorted(os.listdir(path)) == ["params.npz", "train_state.pt"]
    assert os.listdir(tmp_path) == ["step_00000007"]   # no temporary left
    fresh = _state(cfg, 1)
    fresh.step = 0
    checkpoint_io.load_checkpoint(path, fresh)
    _assert_states_equal(saved, fresh)
    # re-saving a step replaces it
    checkpoint_io.save_checkpoint(str(tmp_path), saved, 7)
    assert os.listdir(tmp_path) == ["step_00000007"]

    # another objective's checkpoint needs --ckpt_params_only
    with pytest.raises(ValueError, match="--ckpt_params_only"):
        checkpoint_io.load_checkpoint(path, _state(cfg, 2, mvs_only=True))

    for step in (1, 2, 3):
        checkpoint_io.save_checkpoint(str(tmp_path), saved, step)
    assert sorted(os.listdir(tmp_path)) == [
        "step_00000001", "step_00000002", "step_00000003", "step_00000007"]
    checkpoint_io.save_checkpoint(str(tmp_path), saved, 4, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000004",
                                            "step_00000007"]


def test_checkpoint_params_are_the_jax_tree(tmp_path):
    """``params.npz`` of a native checkpoint loads through the JAX
    package's ``load_params_npz`` into the structure and shapes of its
    ``init_params``, and ``--ckpt <dir>`` gives the port those weights."""
    cfg = parse_config(ARGS)
    state = _state(cfg, 0)
    path = checkpoint_io.save_checkpoint(str(tmp_path), state, 7)
    shapes = jax.eval_shape(lambda k: j_init_params(_jcfg(cfg), k, (H, W)),
                            jax.random.PRNGKey(0))
    tree = j_ckpt.load_params_npz(os.path.join(path, "params.npz"))
    assert jax.tree.structure(tree) == jax.tree.structure(shapes)
    jax.tree.map(lambda a, s: np.testing.assert_equal(a.shape, s.shape),
                 tree, shapes)
    got = checkpoint_io.load_params(cfg.replace(ckpt=path, seed=5), "cpu")
    for name, module in (("nerf", state.nerf), ("mvs", state.mvs)):
        for k, v in module.state_dict().items():
            assert torch.equal(torch.as_tensor(got[name][k]), v), k


def test_orbax_checkpoint_exports_to_the_port(tmp_path):
    """A JAX run's orbax checkpoint, saved by the JAX package from the
    port's seeded weights: the port's ``--ckpt`` refuses it and names the
    export script; ``scripts/export_params_npz.py`` with the run's flags
    writes its params to an npz that the port loads equal, tensor for
    tensor."""
    cfg = parse_config(ARGS)
    sd = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    jstate = JTrainState(params=jax_params_from_state_dict(sd),
                         opt_state={"count": np.int32(4)}, step=np.int32(4))
    orbax_dir = j_ckpt.save_checkpoint(str(tmp_path / "ckpts"), jstate, 4)
    with pytest.raises(ValueError, match="scripts/export_params_npz.py"):
        checkpoint_io.load_params(cfg.replace(ckpt=orbax_dir), "cpu")
    spec = importlib.util.spec_from_file_location(
        "export_params_npz", ROOT / "scripts" / "export_params_npz.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out = script.main([orbax_dir, str(tmp_path / "params.npz"), *ARGS])
    got = checkpoint_io.load_params(cfg.replace(ckpt=out, seed=0), "cpu")
    for name in ("nerf", "mvs"):
        assert sorted(got[name]) == sorted(sd[name])
        for k, v in sd[name].items():
            assert torch.equal(torch.as_tensor(got[name][k]), v), k


def _reference_files(tmp_path, jparams):
    """A ucnerf.tar (with the reference's unused MLP layers) and a
    casmvsnet.ckpt, exported by the JAX package."""
    rng = np.random.default_rng(0)
    sd_nerf = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
               j_ckpt.export_nerf_state_dict(jparams["nerf"]).items()}
    for layer in ("feature_linear_1", "confi_linear",
                  "pts_bias_confidence_1"):
        sd_nerf[f"nerf.{layer}.weight"] = torch.from_numpy(
            rng.standard_normal((4, 8)).astype(np.float32))
        sd_nerf[f"nerf.{layer}.bias"] = torch.zeros(4)
    sd_mvs = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
              j_ckpt.export_casmvsnet_state_dict(jparams["mvs"]).items()}
    tar, ckpt = str(tmp_path / "ucnerf.tar"), str(tmp_path / "casmvsnet.ckpt")
    torch.save({"global_step": 5000, "network_fn_state_dict": sd_nerf,
                "network_mvs_state_dict": sd_mvs}, tar)
    torch.save({"epoch": 15, "model": sd_mvs}, ckpt)
    return tar, ckpt


def test_reference_checkpoints_match_jax_conversion(tmp_path):
    cfg = parse_config(ARGS)
    trained = init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    tar, ckpt = _reference_files(tmp_path,
                                 jax_params_from_state_dict(trained))
    seeded = init_params(cfg, torch.Generator().manual_seed(cfg.seed), "cpu")
    for path, subtrees in ((tar, ("nerf", "mvs")), (ckpt, ("mvs",))):
        got = checkpoint_io.load_params(cfg.replace(ckpt=path), "cpu")
        want = state_dict_from_jax(j_ckpt.convert_reference_checkpoint(path))
        assert sorted(want) == sorted(subtrees)
        create_models(cfg, "cpu", got)                  # strict load
        for name in ("nerf", "mvs"):
            ref = want.get(name, seeded[name])
            assert sorted(got[name]) == sorted(ref)
            for k, v in ref.items():
                assert torch.equal(torch.as_tensor(got[name][k]),
                                   torch.as_tensor(np.asarray(v))), (path, k)
    bad = str(tmp_path / "bad.tar")
    torch.save({"something": torch.zeros(1)}, bad)
    with pytest.raises(ValueError, match="unrecognized"):
        checkpoint_io.load_params(cfg.replace(ckpt=bad), "cpu")


def test_state_dict_from_jax_matches_export():
    """The cascade's seeded weights (V=4) carried into the JAX tree and
    back equal the JAX package's export to reference naming, key for key,
    less the BN running statistics the port does not keep."""
    params = jax_params_from_state_dict({"mvs": init_params(
        Config(view_num=4), torch.Generator().manual_seed(0), "cpu")["mvs"]}
    )["mvs"]
    ours = mvs_state_dict_from_jax(params)
    ref = {k: v for k, v in export_casmvsnet_state_dict(params).items()
           if not k.endswith(("running_mean", "running_var",
                              "num_batches_tracked"))}
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_gather_batch_bit_exact_over_two_epochs():
    """Every sample of two epochs of a two-scan dataset: the store-fed
    batch equals ``__getitem__``'s, field for field, dtype and bits (the
    eval-only GT depth ``depths_h`` is served as zeros)."""
    cfg = parse_config([*ARGS, "--n_scans", "2", "--samples_per_scene", "3"])
    ds = build_dataset(cfg, "train")
    store = build_store(ds, "cpu")
    assert store_nbytes(store) == sum(
        a.numel() * a.element_size() for a in
        [v for v in store.values() if isinstance(v, torch.Tensor)]
        + [a for k in ("sparse_depth_ms", "weight_ms")
           for a in store[k].values()])
    assert {m[0] for m in ds.metas} == {"synth0", "synth1"}

    def check(host, dev, key):
        if isinstance(host, dict):
            for k in host:
                check(host[k], dev[k], f"{key}/{k}")
            return
        assert host.dtype == dev.dtype and host.shape == dev.shape, key
        assert torch.equal(host, dev), key

    for epoch in (0, 1):
        ds.set_epoch(epoch)
        for idx in range(len(ds)):
            host = to_device_batch(ds[idx], "cpu")
            dev = gather_batch(store, to_device_batch(
                sample_indices(ds, idx), "cpu"))
            assert sorted(host) == sorted(dev)
            assert not dev["depths_h"].any()
            for k in host:
                if k != "depths_h":
                    check(host[k], dev[k], k)
