"""ucnerf_torch's loss modules against the JAX package's on the same random
inputs (rtol 1e-5, as ``tests/test_loss_parity.py`` holds the JAX ones to
the reference), the gradients of the 5-term total, and the scene losses at
bf16 and under --mvs_only (the float32 scene loss and its gradients are in
``tests/test_torch_train.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ucnerf_tpu.config import Config as JConfig
from ucnerf_tpu.models.factory import create_models as j_create_models
from ucnerf_tpu.train import loop as j_loop
from ucnerf_tpu.train import losses as j_loss

from ucnerf_torch.config import Config
from ucnerf_torch.render.serving import to_device_batch
from ucnerf_torch.train import loop as t_loop
from ucnerf_torch.train import losses as t_loss

from test_torch_train import _draws, _jcfg, _port, case  # noqa: F401

torch.set_num_threads(1)

RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _stage_maps(rng):
    """Per-stage MVS depth, splatted sparse depth and weights whose
    supports coincide, as the dataset splats them."""
    est, gt, wt = {}, {}, {}
    for k, (h, w) in zip((1, 2, 3), ((8, 10), (16, 20), (32, 40))):
        support = (rng.uniform(size=(h, w)) < 0.3).astype(np.float32)
        est[f"stage{k}"] = (np.abs(rng.standard_normal((h, w))) * 3
                            ).astype(np.float32)
        gt[f"stage{k}"] = (np.abs(rng.standard_normal((h, w))) * 3
                           * support).astype(np.float32)
        wt[f"stage{k}"] = (rng.uniform(0.5, 2.0, (h, w))
                           * support).astype(np.float32)
    return est, gt, wt


def test_elementwise_losses(rng):
    a = rng.standard_normal((100, 3)).astype(np.float32)
    b = rng.standard_normal((100, 3)).astype(np.float32) * 2
    np.testing.assert_allclose(float(t_loss.img2mse(_t(a), _t(b))),
                               float(j_loss.img2mse(a, b)), rtol=RTOL)
    for mse in (np.float32(0.0137), np.float32(0.0)):
        np.testing.assert_allclose(float(t_loss.mse2psnr(_t(mse))),
                                   float(j_loss.mse2psnr(mse)), rtol=RTOL)
    np.testing.assert_allclose(t_loss.smooth_l1(_t(a), _t(b)).numpy(),
                               np.asarray(j_loss.smooth_l1(a, b)), rtol=RTOL)


def test_cas_mvsnet_loss(rng):
    est, gt, wt = _stage_maps(rng)
    j = j_loss.cas_mvsnet_loss({k: {"depth": v} for k, v in est.items()},
                               gt, wt)
    t = t_loss.cas_mvsnet_loss({k: {"depth": _t(v)} for k, v in est.items()},
                               {k: _t(v) for k, v in gt.items()},
                               {k: _t(v) for k, v in wt.items()})
    np.testing.assert_allclose(float(t), float(j), rtol=RTOL)


def test_edge_preserving_smoothness(rng):
    d = rng.standard_normal((6, 5, 5)).astype(np.float32)
    w = rng.standard_normal((6, 5, 5, 1)).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        float(t_loss.edge_preserving_smoothness(_t(d), _t(w))),
        float(j_loss.edge_preserving_smoothness(d, w)), rtol=RTOL)


@pytest.mark.parametrize("degenerate", [False, True])
def test_scale_shift_and_gradient_loss(rng, degenerate):
    """Includes the singular branch: a constant-zero prediction (det == 0)
    gives s = t = 0."""
    pred = rng.standard_normal((6, 5, 5)).astype(np.float32) + 2.0
    if degenerate:
        pred[:] = 0.0
    target = rng.standard_normal((6, 5, 5)).astype(np.float32) + 2.0
    mask = (rng.uniform(size=(6, 5, 5)) < 0.8).astype(np.float32)
    s_t, t_t = t_loss._compute_scale_and_shift(_t(pred), _t(target),
                                               _t(mask))
    s_j, t_j = j_loss._compute_scale_and_shift(pred, target, mask)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=RTOL,
                               atol=1e-6)
    for m in (None, mask):
        np.testing.assert_allclose(
            float(t_loss.gradient_scaleinv_loss(
                _t(pred), _t(target), None if m is None else _t(m))),
            float(j_loss.gradient_scaleinv_loss(pred, target, m)),
            rtol=RTOL)


def test_total_loss_terms_and_gradients(rng):
    """The 5-term total, each term, and its gradients with respect to the
    rendered colour and depth and the MVS depth maps."""
    pn, ps, n_depth = 6, 4, 16
    n_fixed = pn * ps * ps + 8
    n_total = n_fixed + n_depth
    kw = dict(batch_size=n_fixed, patch_size=ps, patch_num=pn,
              n_depth_rays=n_depth)
    est, gt, wt = _stage_maps(rng)
    rgb = rng.uniform(size=(n_total, 3)).astype(np.float32)
    depth = rng.uniform(1.0, 4.0, n_total).astype(np.float32)
    fixed = dict(
        target_rgb=rng.uniform(size=(n_total, 3)).astype(np.float32),
        sparse_depth_ms=gt, weight_ms=wt,
        target_depths=rng.uniform(1.0, 4.0, n_depth).astype(np.float32),
        target_weights=rng.uniform(0.2, 2.0, n_depth).astype(np.float32),
        depth_ray_mask=(np.arange(n_total) < n_total - 3).astype(np.float32),
        dpt_patches=rng.standard_normal((pn, ps, ps)).astype(np.float32),
        n_rays_fixed=n_fixed)

    def j_fn(rgb, depth, est):
        return j_loss.total_loss(
            JConfig(**kw), rgb=rgb, depth_pred=depth,
            mvs_out={k: {"depth": v} for k, v in est.items()}, **fixed)

    (j_total, j_terms), j_grads = jax.jit(jax.value_and_grad(
        j_fn, argnums=(0, 1, 2), has_aux=True))(rgb, depth, est)

    args = [_t(rgb).requires_grad_(), _t(depth).requires_grad_(),
            {k: _t(v).requires_grad_() for k, v in est.items()}]
    t_total, t_terms = t_loss.total_loss(
        Config(**kw), rgb=args[0], depth_pred=args[1],
        mvs_out={k: {"depth": v} for k, v in args[2].items()},
        **{k: (v if k == "n_rays_fixed" else
               {kk: _t(vv) for kk, vv in v.items()} if isinstance(v, dict)
               else _t(v)) for k, v in fixed.items()})
    t_total.backward()

    assert sorted(t_terms) == sorted(j_terms)
    for name in j_terms:
        np.testing.assert_allclose(float(t_terms[name].detach()),
                                   float(j_terms[name]), rtol=RTOL,
                                   err_msg=name)
    np.testing.assert_allclose(float(t_total.detach()), float(j_total),
                               rtol=RTOL)
    pairs = [(args[0].grad, j_grads[0]), (args[1].grad, j_grads[1])]
    pairs += [(args[2][k].grad, j_grads[2][k]) for k in est]
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   atol=1e-6 * np.abs(want).max())


def test_bf16_and_mvs_only_losses_match_jax(case):
    """At --nerf_dtype bfloat16 the loss terms agree to 2e-2 (the MLP
    rounds to bf16 at the same points on both sides; the two cascades'
    float32 round-off moves the rounded values).  --mvs_only: the loss
    and its depth diagnostic agree to 6e-3, and a train step leaves the
    MLP as it was (zero gradients, zero Adam moments)."""
    key = jax.random.PRNGKey(5)
    batch_j = j_loop.to_device_batch(case["sample"])
    batch = to_device_batch(case["sample"], "cpu")
    jp = jax.tree.map(jnp.asarray, case["jparams"])
    for flags, rtol in ((dict(nerf_dtype="bfloat16"), 2e-2),
                        (dict(mvs_only=True), 6e-3)):
        cfg = case["cfg"].replace(**flags)
        jcfg = _jcfg(cfg)
        jnerf, jmvs = j_create_models(jcfg)
        _, terms_j = jax.jit(lambda p: j_loop.scene_loss(
            jcfg, jnerf, jmvs, p, batch_j, key))(jp)
        nerf, mvs = _port(cfg, case["params"])
        with torch.no_grad():
            _, terms = t_loop.scene_loss(cfg, nerf, mvs, batch,
                                         _draws(cfg, key))
        assert sorted(terms) == sorted(terms_j)
        for name in terms_j:
            np.testing.assert_allclose(float(terms[name]),
                                       float(terms_j[name]), rtol=rtol,
                                       err_msg=f"{flags} {name}")

    before = {n: p.detach().clone() for n, p in nerf.named_parameters()}
    state = t_loop.TrainState(nerf, mvs, t_loop.make_optimizer(cfg, nerf,
                                                               mvs))
    t_loop.make_train_step(cfg, t_loop.make_lr_schedule(cfg, 10))(
        state, batch, None)
    assert state.step == 1
    for n, p in nerf.named_parameters():
        torch.testing.assert_close(p.detach(), before[n], rtol=0, atol=0)
