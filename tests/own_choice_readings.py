"""Readings behind the data and bounds of two tests of the port's train
step on its own ReLU choices.  pytest does not collect it.

Run from the repository root (CPU only):

    python tests/own_choice_readings.py --patch_odd 1 2 3 4 5 6 7 8 9 10 11 12
    python tests/own_choice_readings.py --bf16_threads 1 2 4 8

``--patch_odd KEY...``: for each JAX key, ``odd_patch_gaps`` of
``tests/test_torch_train_patch_odd.py`` (``--patch_num 5``), one JSON
line: for the port's step on the JAX step's ReLU choices (``jax``) and on
its own (``own``), the largest loss-term rel and the median and worst,
over the 154 gradient tensors, of max |a - b| over the larger max |.|;
and the ReLU samples whose sign differs (``flips``).

``--bf16_threads N...``: the bf16 step at ``SCENE_REFS["bf16"]`` of
``tests/test_torch_train_bf16.py``'s regression guard, the port on its own
ReLU choices with ``torch.set_num_threads(N)``, against the JAX step
compiled without excess precision at optimization level 0 (``level0``,
what the guard reads) and at XLA's default (``default``): one JSON line
per N with the median and worst rel against each.
"""

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from test_torch_train import (EXACT_BF16, JIT_QUICK, SCENE_REFS,  # noqa: E402
                              _case, _draws, _grads, _jcfg, _port,
                              _rel_envelope)


def _summary(rels: dict) -> dict:
    return dict(median=float(np.median(list(rels.values()))),
                worst=max(rels.values()))


def patch_odd(keys):
    from test_torch_train_patch_odd import odd_patch_gaps
    c = _case()
    for key in keys:
        g = odd_patch_gaps(c, key)
        line = dict(key=key, flips=g["flips"])
        for choices in ("jax", "own"):
            terms = g[choices]["terms"]
            line[choices] = dict(
                _summary(g[choices]["rels"]),
                terms=max(abs(terms[k] / g["terms_j"][k] - 1)
                          for k in g["terms_j"] if g["terms_j"][k] != 0))
        print(json.dumps(line), flush=True)


def bf16_threads(threads):
    from ucnerf_tpu.models.factory import create_models as j_create_models
    from ucnerf_tpu.train import loop as j_loop
    from ucnerf_torch.render.serving import to_device_batch
    from ucnerf_torch.train import loop as t_loop
    from ucnerf_torch.utils.checkpoint_io import state_dict_from_jax
    c = _case()
    flags, seed, _ = SCENE_REFS["bf16"]
    cfg = c["cfg"].replace(**flags)
    jcfg = _jcfg(cfg)
    jnerf, jmvs = j_create_models(jcfg)
    batch = j_loop.to_device_batch(c["sample"])
    p = jax.tree.map(jnp.asarray, c["jparams"])
    key = jax.random.PRNGKey(seed)
    step = jax.jit(jax.grad(lambda q: j_loop.scene_loss(
        jcfg, jnerf, jmvs, q, batch, key)[0]))
    want = {}
    for name, opts in (("level0", {**JIT_QUICK, **EXACT_BF16}),
                       ("default", EXACT_BF16)):
        sd = state_dict_from_jax(jax.tree.map(
            np.asarray, step.lower(p).compile(opts)(p)))
        want[name] = {**sd["nerf"], **sd["mvs"]}
    for n in threads:
        torch.set_num_threads(n)
        nerf, mvs = _port(cfg, c["params"])
        loss, _ = t_loop.scene_loss(cfg, nerf, mvs,
                                    to_device_batch(c["sample"], "cpu"),
                                    _draws(cfg, key))
        loss.backward()
        got = _grads(nerf, mvs)
        print(json.dumps(dict(threads=n, **{
            name: _summary(_rel_envelope(got, w))
            for name, w in want.items()})), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--patch_odd", type=int, nargs="+", metavar="KEY")
    parser.add_argument("--bf16_threads", type=int, nargs="+", metavar="N")
    args = parser.parse_args(argv)
    if args.patch_odd:
        patch_odd(args.patch_odd)
    if args.bf16_threads:
        bf16_threads(args.bf16_threads)


if __name__ == "__main__":
    main()
