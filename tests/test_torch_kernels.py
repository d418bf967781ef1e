"""ucnerf_torch's CUDA kernels against their plain PyTorch versions.

Imports neither JAX nor the JAX package, so it also runs on the card's
machine, without this directory's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py

The ``cuda`` tests skip where there is no card; the others check the
wrappers' guards on the CPU.
"""

import numpy as np
import pytest
import torch

from ucnerf_torch.config import Config
from ucnerf_torch.kernels.fused_mlp import (FusedNeRFMLP, fused_nerf_mlp,
                                            pack_mlp_weights)
from ucnerf_torch.models.factory import create_models, init_params

torch.set_num_threads(1)


def _mlps(view_num, device):
    cfg = Config(view_num=view_num)
    params = init_params(cfg, torch.Generator().manual_seed(0), device)
    return {dt: create_models(cfg.replace(nerf_dtype=dt), device, params)[0]
            for dt in ("float32", "bfloat16")}, cfg


def _inputs(n, s, feat_dim, device, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, (n, s, 3))
    dirs = rng.standard_normal((n, 3))
    feats = rng.standard_normal((n, s, feat_dim))
    feats[..., -1] = rng.uniform(0, 1, (n, s))
    return [torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in (pts, dirs, feats)]


def test_wrapper_rejects_mixed_devices():
    mlps, cfg = _mlps(5, "cpu")
    packed = pack_mlp_weights(mlps["float32"])
    pts, dirs, feats = _inputs(4, 6, cfg.feat_dim, "cpu")
    with pytest.raises(ValueError, match="devices"):
        fused_nerf_mlp(pts, dirs, feats.to("meta"), packed)


def test_pack_rejects_shapes_the_kernel_does_not_take():
    cfg = Config(view_num=5, netwidth=64)
    nerf, _ = create_models(cfg, "cpu")
    with pytest.raises(ValueError, match="width 128"):
        pack_mlp_weights(nerf)


def test_bf16_pack_on_cpu_runs_plain_version():
    """A bf16 ``PackedMLP`` on CPU tensors gives the plain bf16 MLP
    exactly, and launches nothing."""
    mlps, cfg = _mlps(7, "cpu")
    packed = pack_mlp_weights(mlps["bfloat16"])
    assert packed.use_bf16
    x = _inputs(3, 5, cfg.feat_dim, "cpu")
    before = fused_nerf_mlp.launches
    with torch.no_grad():
        got = fused_nerf_mlp(*x, packed)
        want = mlps["bfloat16"](*x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert fused_nerf_mlp.launches == before


def test_wrapper_refuses_autograd():
    """The kernel has no backward: with grad enabled and an input or a
    weight that requires grad the wrapper raises on either device, rather
    than return an output that carries no gradient.  Under no_grad, or
    with nothing requiring grad, it runs."""
    mlps, cfg = _mlps(5, "cpu")
    fused = FusedNeRFMLP(mlps["float32"])
    pts, dirs, feats = _inputs(3, 4, cfg.feat_dim, "cpu")
    with pytest.raises(RuntimeError, match="no backward"):
        fused(pts, dirs, feats)                       # weights require grad
    with pytest.raises(RuntimeError, match="no backward"):
        with torch.no_grad():
            packed = pack_mlp_weights(mlps["float32"])
        for p in mlps["float32"].parameters():
            p.requires_grad_(False)
        fused_nerf_mlp(pts.requires_grad_(), dirs, feats, packed)
    with torch.no_grad():
        assert fused(pts, dirs, feats).shape == (3, 4, 4)
    assert fused(pts.detach(), dirs, feats).shape == (3, 4, 4)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("view_num,n_rays,n_samples",
                         [(7, 1024, 90), (7, 37, 90), (4, 33, 12),
                          (7, 1, 12), (7, 64, 12), (7, 43, 3)])
def test_fused_mlp_matches_plain(card, view_num, n_rays, n_samples):
    """f32: max abs err <= 1e-4 against the plain f32 MLP.  bf16: the JAX
    package's bounds against that f32 truth (mean error within 2x the plain
    bf16 version's + 5e-3, 99th percentile <= 0.25), and a mean abs diff to
    the plain bf16 version of 1e-4 (both round at the same points).  Ragged
    point counts exercise the masked last tile; at the bf16 kernel's
    128-point blocks: 12 points (less than a block), 768 (six blocks) and
    129 (one point past a block)."""
    mlps, cfg = _mlps(view_num, card)
    x = _inputs(n_rays, n_samples, cfg.feat_dim, card, seed=n_rays)
    before = fused_nerf_mlp.launches
    with torch.no_grad():
        truth = mlps["float32"](*x)
        k32 = FusedNeRFMLP(mlps["float32"])(*x)
        k16 = FusedNeRFMLP(mlps["bfloat16"])(*x)
        p16 = mlps["bfloat16"](*x)
    torch.cuda.synchronize()
    assert fused_nerf_mlp.launches == before + 2
    assert (k32 - truth).abs().max().item() <= 1e-4
    err = (k16 - truth).abs()
    assert err.mean() <= 2 * (p16 - truth).abs().mean() + 5e-3
    assert torch.quantile(err.flatten(), 0.99) <= 0.25
    assert (k16 - p16).abs().mean() <= 1e-4
