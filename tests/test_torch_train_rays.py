"""ucnerf_torch's train-ray builder against the JAX package's, fed the
draws JAX makes from one key: the Gumbel top-k patch draw, the patch
pixels and the whole [patches | uniform | sparse-depth] batch."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ucnerf_tpu.ops import rays as j_rays

from ucnerf_torch.ops import rays as t_rays

torch.set_num_threads(1)

H, W = 32, 64
PS, PN, N_UNIFORM, N_DEPTH, S = 4, 4, 16, 32, 9
# compile time, not run time, dominates these references on the CPU
JIT_QUICK = {"xla_backend_optimization_level": 0}


def jax_train_draws(key, *, H, W, patch_size, patch_num, n_uniform, n_rays,
                    n_samples):
    """The draws ``ucnerf_tpu.ops.rays.build_train_rays`` makes from
    ``key``, through its key splits (``rays.py:164``, ``:75``, ``:169``)
    and the jitter's (``ops/sampling.py:33``), as a port ``TrainDraws``.
    Compiled once per shape: op by op, each random primitive compiles on
    its own."""
    return t_rays.TrainDraws(*(
        torch.from_numpy(np.array(a)) for a in _jax_draws(
            key, H, W, patch_size, patch_num, n_uniform, n_rays, n_samples)))


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6, 7))
def _jax_draws(key, H, W, patch_size, patch_num, n_uniform, n_rays,
               n_samples):
    k1, k2, k3, kd = jax.random.split(key, 4)
    gumbel, shifts = [], []
    for k in (k1, k2):
        k_sel, k_shift = jax.random.split(k)
        gumbel.append(jax.random.gumbel(k_sel, (H * W,), dtype=jnp.float32))
        shifts.append(jax.random.randint(k_shift, (2, patch_num // 2), 0,
                                         patch_size))
    ku_x, ku_y = jax.random.split(k3)
    xs = jax.random.randint(ku_x, (n_uniform,), 0, W)
    ys = jax.random.randint(ku_y, (n_uniform,), 0, H)
    jitter = jax.random.uniform(kd, (n_rays, 3 * (n_samples // 3)),
                                dtype=jnp.float32)
    return jnp.stack(gumbel), jnp.stack(shifts), xs, ys, jitter


def _inputs(seed=0):
    """Random ray-builder inputs.  The confidence holds a few exact 0s and
    1s (stage_head clamps it to [0, 1]), but far fewer than H*W - k, so
    neither patch half's top-k reaches the -inf logits of zero weights:
    ties among -inf may be ordered differently by torch.topk and
    lax.top_k, which matters only when fewer than k weights are
    positive."""
    rng = np.random.default_rng(seed)
    conf = rng.uniform(0.0, 1.0, (H, W)).astype(np.float32)
    conf.reshape(-1)[rng.choice(H * W, 20, replace=False)] = 0.0
    conf.reshape(-1)[rng.choice(H * W, 20, replace=False)] = 1.0
    planes = {}
    for k, scale in ((1, 4), (2, 2), (3, 1)):
        near = rng.uniform(0.8, 1.2, (H // scale, W // scale))
        far = near + rng.uniform(0.5, 1.5, (H // scale, W // scale))
        planes[k] = (near.astype(np.float32), far.astype(np.float32))
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.1, -0.05, 0.02]
    intrinsic = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]],
                         np.float32)
    n_valid = 25
    coords = np.zeros((N_DEPTH, 2), np.int32)
    coords[:n_valid] = np.stack([rng.integers(0, H, n_valid),
                                 rng.integers(0, W, n_valid)], -1)
    mask = (np.arange(N_DEPTH) < n_valid).astype(np.float32)
    return dict(image_tgt=rng.uniform(0, 1, (H, W, 3)).astype(np.float32),
                confidence=conf, sparse_coords=coords, sparse_mask=mask,
                intrinsic=intrinsic, c2w=c2w, near_ref=np.float32(0.7),
                far_ref=np.float32(2.9), stage_planes=planes)


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, fn) for v in tree)
    return fn(tree)


@pytest.mark.parametrize("jitter", [True, False])
def test_build_train_rays_matches_jax(jitter):
    inp = _inputs()
    key = jax.random.PRNGKey(7)
    n_rays = PN * PS * PS + N_UNIFORM + N_DEPTH
    j = jax.jit(functools.partial(
        j_rays.build_train_rays, patch_size=PS, patch_num=PN,
        n_uniform=N_UNIFORM, n_samples=S, jitter=jitter),
        compiler_options=JIT_QUICK)(
        key, **_to(inp, jnp.asarray), w2c_ref=jnp.eye(4),
        intrinsic_ref=jnp.asarray(inp["intrinsic"]))
    draws = jax_train_draws(key, H=H, W=W, patch_size=PS, patch_num=PN,
                            n_uniform=N_UNIFORM, n_rays=n_rays, n_samples=S)
    t = t_rays.build_train_rays(
        draws, **_to(inp, lambda a: torch.from_numpy(np.array(a))),
        patch_size=PS, patch_num=PN, n_samples=S, jitter=jitter)

    np.testing.assert_array_equal(t["pixel_coords"].numpy(),
                                  np.asarray(j["pixel_coords"]))
    assert t["pixel_coords"].shape == (n_rays, 2)
    for name in ("rays_o", "rays_d", "depth_candidates", "points_world",
                 "colors", "depth_ray_mask"):
        np.testing.assert_allclose(t[name].numpy(), np.asarray(j[name]),
                                   rtol=0, atol=1e-5, err_msg=name)
    for name in ("stage1", "stage2", "stage3", "ndc"):
        np.testing.assert_allclose(t["ndc"][name].numpy(),
                                   np.asarray(j["ndc"][name]), rtol=0,
                                   atol=1e-5, err_msg=name)
    # the uniform rays and the sparse-depth slots sit where the order says
    n_patch = PN * PS * PS
    np.testing.assert_array_equal(
        t["pixel_coords"][n_patch:n_patch + N_UNIFORM].numpy(),
        np.stack([draws.ys.numpy(), draws.xs.numpy()], -1))
    np.testing.assert_array_equal(
        t["pixel_coords"][n_patch + N_UNIFORM:].numpy(), inp["sparse_coords"])


def test_gumbel_topk_matches_jax_and_skips_zero_weights():
    """Fed the same noise, the port picks JAX's indices, and a zero weight
    is never picked while k positive weights exist."""
    rng = np.random.default_rng(3)
    w = rng.uniform(0.0, 1.0, 500).astype(np.float32)
    w[rng.choice(500, 480, replace=False)] = 0.0       # 20 positive
    key = jax.random.PRNGKey(11)
    g = jax.random.gumbel(key, (500,), dtype=jnp.float32)
    j = np.asarray(j_rays.gumbel_topk_sample(key, jnp.asarray(w), 12))
    t = t_rays.gumbel_topk_sample(torch.from_numpy(np.array(g)),
                                  torch.from_numpy(w), 12).numpy()
    np.testing.assert_array_equal(t, j)
    assert (w[t] > 0).all()


def test_draw_train_randomness_shapes_ranges_and_seed():
    kw = dict(H=H, W=W, patch_size=PS, patch_num=PN, n_uniform=N_UNIFORM,
              n_rays=100, n_samples=S)
    a = t_rays.draw_train_randomness(torch.Generator().manual_seed(5), **kw)
    b = t_rays.draw_train_randomness(torch.Generator().manual_seed(5), **kw)
    c = t_rays.draw_train_randomness(torch.Generator().manual_seed(6), **kw)
    assert a.gumbel.shape == (2, H * W) and torch.isfinite(a.gumbel).all()
    assert a.shifts.shape == (2, 2, PN // 2)
    assert 0 <= a.shifts.min() and a.shifts.max() < PS
    assert a.xs.shape == a.ys.shape == (N_UNIFORM,)
    assert 0 <= a.xs.min() and a.xs.max() < W
    assert 0 <= a.ys.min() and a.ys.max() < H
    assert a.jitter.shape == (100, 9)
    assert 0 <= a.jitter.min() and a.jitter.max() < 1
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert not torch.equal(a.gumbel, c.gumbel)
