"""The renderer's options in ucnerf_torch against the JAX package's: the
grid samplers of the literal featurization, and the names
``--mvs_dtype`` takes.  (An eval render with ``--use_color_volume`` and
``--eval_jitter``'s tile are in ``tests/test_torch_options_render.py``,
the literal featurization's tensors in ``tests/test_torch_ops.py``, its
train step in ``tests/test_torch_train_grads.py``, the bf16 cascade in
``tests/test_torch_mvs.py``.)"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ucnerf_tpu.ops import grid_sample as j_gs

from ucnerf_torch.config import Config
from ucnerf_torch.models.factory import compute_dtype, create_models
from ucnerf_torch.ops import grid_sample as t_gs

torch.set_num_threads(1)

# compile time, not run time, dominates these references on the CPU
JIT_QUICK = {"xla_backend_optimization_level": 0}
GS_CASES = [(dims, mode, pad, ac) for dims, mode, pad, ac in itertools.product(
    (2, 3), ("bilinear", "nearest"), ("border", "zeros"), (False, True))
    if not (dims == 3 and mode == "nearest")]


@pytest.fixture(scope="module")
def grids():
    """A [6, 5, 4] image and a [3, 6, 5, 4] volume, and grids reaching
    past [-1, 1] on every axis, with points at exact half-pixel positions
    (the nearest mode's ties) for both corner conventions; every JAX
    sample compiled as one function."""
    rng = np.random.default_rng(3)
    img = rng.standard_normal((6, 5, 4)).astype(np.float32)
    vol = rng.standard_normal((3, 6, 5, 4)).astype(np.float32)
    g2 = rng.uniform(-1.3, 1.3, (40, 2)).astype(np.float32)
    g3 = rng.uniform(-1.3, 1.3, (40, 3)).astype(np.float32)
    # x = 1.5 px: (2*1.5 + 1) / 5 - 1 without, 1.5 / 2 - 1 with corners
    ties = np.array([[-0.2, -0.5], [-0.25, -0.25], [0.2, 0.5]], np.float32)
    g2 = np.concatenate([g2, ties])

    def refs(img, vol, g2, g3):
        return {c: (j_gs.grid_sample_2d(img, g2, c[1], c[2], c[3])
                    if c[0] == 2 else
                    j_gs.grid_sample_3d(vol, g3, c[1], c[2], c[3]))
                for c in GS_CASES}
    j = jax.jit(refs, compiler_options=JIT_QUICK)(img, vol, g2, g3)
    return dict(img=img, vol=vol, g2=g2, g3=g3,
                j={c: np.asarray(v) for c, v in j.items()})


@pytest.mark.parametrize("dims,mode,padding,align_corners", GS_CASES)
def test_grid_sample_matches_jax(grids, dims, mode, padding, align_corners):
    """``ops.grid_sample`` against the JAX package's samplers: every mode,
    padding and corner convention each has (3D: trilinear only)."""
    t = lambda a: torch.from_numpy(np.array(a))
    if dims == 2:
        got = t_gs.grid_sample_2d(t(grids["img"]), t(grids["g2"]), mode,
                                  padding, align_corners)
    else:
        got = t_gs.grid_sample_3d(t(grids["vol"]), t(grids["g3"]), mode,
                                  padding, align_corners)
    want = grids["j"][(dims, mode, padding, align_corners)]
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_grid_sample_3d_refuses_nearest():
    vol = torch.zeros((2, 2, 2, 1))
    with pytest.raises(ValueError, match="nearest"):
        t_gs.grid_sample_3d(vol, torch.zeros((1, 3)), mode="nearest")
    with pytest.raises(ValueError, match="nearest"):
        j_gs.grid_sample_3d(jnp.asarray(vol.numpy()), jnp.zeros((1, 3)),
                            mode="nearest")


def test_mvs_dtype_names():
    """``--mvs_dtype`` takes the floating dtype names ``jnp.dtype`` takes
    (float32 means no cast); a name that is not a torch floating dtype
    raises ValueError, before any model is built."""
    assert compute_dtype("float32") is None
    assert compute_dtype("bfloat16") == torch.bfloat16
    assert compute_dtype("float16") == compute_dtype("half") == torch.float16
    for name in ("int8", "bf16", "complex64"):
        with pytest.raises(ValueError, match="mvs_dtype"):
            create_models(Config(view_num=4, mvs_dtype=name), "cpu")
