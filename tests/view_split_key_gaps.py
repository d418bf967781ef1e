"""Per-key gradient gaps of the padded view-split ray-DP case of
``tests/test_torch_parallel.py`` (117 rays, ``--shard_mvs_views``, 2
ranks), beside the single-device gap of the same draws.  pytest does not
collect it.

Run from the repository root (CPU only; a few minutes):

    python tests/view_split_key_gaps.py 1 2 3 4 5 6 7 8 9 10 11 12

For each JAX key it prints one JSON line with the median, over the 154
gradient tensors, of max |a - b| over the larger max |.| (the statistic
that the test holds under 5e-3 against JAX), for:

- ``port2_jax2``: the port's 2-rank view split against JAX's
  ``_ray_dp_loss_fn`` with the view split on a 2-device mesh;
- ``port1_jax1``: the port's serial ``scene_loss`` against JAX's, the
  single-device parity gap of the same draws;
- ``jax2_jax1`` and ``port2_port1``: each package's view split against
  its own serial step.
"""

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")
_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

import dataclasses  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import jax_parallel_refs  # noqa: E402
import test_torch_parallel as tp  # noqa: E402
from test_torch_train import _case, _draws, _jcfg  # noqa: E402
from ucnerf_tpu.models.factory import create_models as j_create_models  # noqa: E402,E501
from ucnerf_tpu.train import loop as j_loop  # noqa: E402
from ucnerf_torch.utils.checkpoint_io import state_dict_from_jax  # noqa: E402,E501


def _flat(grads_j) -> dict:
    sd = state_dict_from_jax(grads_j)
    return {f"{name}/{n}": v for name in ("nerf", "mvs")
            for n, v in sd[name].items()}


def _median(got: dict, want: dict) -> float:
    return float(np.median(list(tp._rels(got, want).values())))


def main(keys):
    torch.set_num_threads(1)
    c = _case()
    cfg = c["cfg"].replace(**tp.RAY_CASES["padded_views"][0])
    p = jax.tree.map(jnp.asarray, c["jparams"])
    batch = j_loop.to_device_batch(c["sample"])
    split, args = jax_parallel_refs.lowered("rays", dict(
        cfg=dataclasses.asdict(cfg), params=c["jparams"],
        sample=c["sample"], seed=keys[0]))
    split = split.compile(jax_parallel_refs.JIT_QUICK)
    jcfg = _jcfg(cfg.replace(shard_mvs_views=False))
    jnerf, jmvs = j_create_models(jcfg)
    serial = jax.jit(jax.value_and_grad(
        lambda pm, b, k: j_loop.scene_loss(jcfg, jnerf, jmvs, pm, b, k),
        has_aux=True)).lower(p, batch, jax.random.PRNGKey(0)).compile(
            jax_parallel_refs.JIT_QUICK)
    draws = {k: _draws(cfg, jax.random.PRNGKey(k)) for k in keys}
    jobs = [dict(kind="loss", argv=tp._argv(cfg, parallel_mode="rays",
                                            **tp.RAY_CASES["padded_views"][0]),
                 params=tp._np_params(c["params"]), samples=[c["sample"]],
                 draws=[tp._draw_arrays(draws[k])]) for k in keys]
    port2 = dict(zip(keys, tp._spawn((2,), ("data",), jobs)))
    for k in keys:
        key = jax.random.PRNGKey(k)
        jax2 = _flat(jax.tree.map(np.asarray, split(args[0], args[1], key))[1])
        jax1 = _flat(jax.tree.map(np.asarray, serial(p, batch, key))[1])
        _, port1 = tp._port_serial(c, cfg, [c["sample"]], [draws[k]])
        got2 = port2[k]["grads"]
        print(json.dumps(dict(
            key=k, port2_jax2=_median(got2, jax2),
            port1_jax1=_median(port1, jax1), jax2_jax1=_median(jax2, jax1),
            port2_port1=_median(got2, port1))), flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [5, 11])
