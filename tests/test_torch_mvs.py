"""ucnerf_torch's CascadeMVSNet against the JAX package's on the same
weights and inputs (32x64, V=4)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ucnerf_tpu.config import Config as JConfig
from ucnerf_tpu.models.factory import create_models as j_create_models
from ucnerf_tpu.utils.checkpoint_io import export_casmvsnet_state_dict

from ucnerf_torch.config import Config
from ucnerf_torch.models.factory import create_models, init_params
from ucnerf_torch.utils.checkpoint_io import (jax_params_from_state_dict,
                                              mvs_state_dict_from_jax)

torch.set_num_threads(1)

H, W, V = 32, 64, 4


def _affines():
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
    affs, affs_inv = [], []
    for v in range(V):
        th = 0.03 * v
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = [[np.cos(th), -np.sin(th), 0],
                       [np.sin(th), np.cos(th), 0], [0, 0, 1]]
        w2c[0, 3] = 0.05 * v
        per, per_i = [], []
        for s in range(3):
            Ks = K.copy()
            Ks[:2] /= 2 ** (2 - s)
            m = np.eye(4, dtype=np.float32)
            m[:3] = Ks @ w2c[:3]
            per.append(m)
            per_i.append(np.linalg.inv(m))
        affs.append(per)
        affs_inv.append(per_i)
    return np.stack(affs), np.stack(affs_inv)


@pytest.fixture(scope="module")
def case():
    """The port's seeded cascade weights carried into the JAX params tree,
    the inputs and the JAX cascade's outputs, computed once."""
    cfg = JConfig(view_num=V, mvs_dtype="float32")
    _, mvs = j_create_models(cfg)
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((V - 1, H, W, 3)).astype(np.float32)
    affine, affine_inv = _affines()
    near, far = np.float32(0.8), np.float32(2.5)
    args = (jnp.asarray(imgs), jnp.asarray(affine), jnp.asarray(affine_inv),
            jnp.asarray(near), jnp.asarray(far))
    params = jax_params_from_state_dict({"mvs": init_params(
        Config(view_num=V), torch.Generator().manual_seed(0), "cpu")["mvs"]}
    )["mvs"]
    out = jax.jit(lambda p, *a: mvs.apply({"params": p}, *a))(params, *args)
    return dict(params=params,
                out=jax.tree.map(np.asarray, out),
                inputs=(imgs, affine, affine_inv, near, far))


@pytest.fixture(scope="module")
def port(case):
    _, mvs = create_models(Config(view_num=V), "cpu")
    sd = mvs_state_dict_from_jax(case["params"])
    mvs.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in sd.items()}, strict=True)
    inputs = [torch.from_numpy(np.array(a)) for a in case["inputs"]]
    with torch.no_grad():
        return mvs, inputs, mvs(*inputs)


def test_state_dict_from_jax_matches_export(case):
    """Equal to the JAX package's export to reference naming, key for key,
    less the BN running statistics the port does not keep."""
    ours = mvs_state_dict_from_jax(case["params"])
    ref = {k: v for k, v in export_casmvsnet_state_dict(case["params"]).items()
           if not k.endswith(("running_mean", "running_var",
                              "num_batches_tracked"))}
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_cascade_matches_jax(case, port):
    _, _, ours = port
    ref = case["out"]
    for k in (1, 2, 3):
        o, r = ours[f"stage{k}"], ref[f"stage{k}"]
        np.testing.assert_allclose(o["depth"].numpy(), r["depth"], rtol=5e-3,
                                   atol=2e-3, err_msg=f"stage{k} depth")
        assert np.abs(o["photometric_confidence"].numpy()
                      - r["photometric_confidence"]).mean() < 2e-3
        np.testing.assert_allclose(o["volume_feature"].numpy(),
                                   r["volume_feature"], rtol=1e-2, atol=5e-3,
                                   err_msg=f"stage{k} volume")
        np.testing.assert_allclose(o["depth_values"].numpy(),
                                   r["depth_values"], rtol=1e-4, atol=1e-4,
                                   err_msg=f"stage{k} depth_values")
    np.testing.assert_allclose(ours["img_feats"].numpy(), ref["img_feats"],
                               rtol=1e-4, atol=1e-4)


def test_from_features_equals_forward(port):
    mvs, inputs, full = port
    with torch.no_grad():
        split = mvs.from_features(mvs.features(inputs[0]), *inputs[1:])
    for k in (1, 2, 3):
        for name, t in full[f"stage{k}"].items():
            torch.testing.assert_close(split[f"stage{k}"][name], t, rtol=0,
                                       atol=0, msg=f"stage{k} {name}")
