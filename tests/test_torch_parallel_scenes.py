"""Scene-DP on 2 ranks and the 2x2 grid of ucnerf_torch against the JAX
package's ``_scene_dp_loss_fn`` and the port's serial steps (the
envelopes of ``tests/test_torch_parallel.py``)."""

import jax
import pytest

from ucnerf_torch.data import build_dataset

from test_torch_parallel import (_argv, _draw_arrays, _port_serial,
                                 check_step, jax_spec, parallel_case,
                                 run_both, spawn_both)
from test_torch_train import _draws

SCENE_KEY = 7


@pytest.fixture(scope="module")
def case():
    return parallel_case()


@pytest.fixture(scope="module")
def scenes(case):
    """Two train-split samples with a JAX key each, the port's scene-DP
    step on 2 ranks and its grid step on 2x2, and JAX's
    ``_scene_dp_loss_fn`` on the batch sharded over 2 devices."""
    cfg = case["cfg"]
    ds = build_dataset(cfg, "train")
    samples = [ds[0], ds[1]]
    draws = [_draws(cfg, k) for k in
             jax.random.split(jax.random.PRNGKey(SCENE_KEY), 2)]
    job = dict(kind="loss", params=case["np_params"], samples=samples,
               draws=[_draw_arrays(d) for d in draws])

    def port():
        two, four = spawn_both(
            ((2,), ("data",), [dict(job, argv=_argv(
                cfg, parallel_mode="scenes", mesh_shape=2))]),
            ((2, 2), ("data", "rays"), [dict(job, argv=_argv(
                cfg, parallel_mode="grid", mesh_shape=(2, 2),
                mesh_axes=("data", "rays")))]))
        return dict(scenes=two[0], grid=four[0])

    got, refs = run_both(port, {"scenes": ("scenes", jax_spec(
        case, samples=samples, seed=SCENE_KEY))})
    return dict(samples=samples, draws=draws, port=got, jax=refs["scenes"])


@pytest.mark.parametrize("mode", ["scenes", "grid"])
def test_scene_batched_modes_match_jax_and_serial(case, scenes, mode):
    """Scene-DP on 2 ranks and the 2x2 grid (2 scenes, each one's rays in
    halves) against ``_scene_dp_loss_fn`` on the scene-sharded batch of a
    2-device mesh (the JAX package's grid computes that objective with 2
    scenes, ``tests/test_parallel_grid.py``) and against the mean of the
    two serial scene losses (rtol 1e-4), with the same per-scene draws."""
    serial = _port_serial(case, case["cfg"], scenes["samples"],
                          scenes["draws"])
    check_step(scenes["port"][mode], scenes["jax"], serial, 1e-4)
