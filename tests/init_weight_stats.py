"""The initial weights of both packages, tensor by tensor, over seeds: do
ucnerf_torch's ``init_params`` and the JAX package's draw from the same
distributions?  pytest does not collect it.

Run from the repository root (CPU only; about a minute):

    python tests/init_weight_stats.py 7 8 9

At ``scripts/quality_seeds.py``'s cut point, for each of the 154 tensors
(by state-dict name), the ratio of the port's standard deviation to the
JAX package's (each averaged over the seeds) and the difference of their
means in units of that deviation.  Prints the tensors whose ratio is off
by more than 10% or whose means differ by more than 0.1 deviations (a
tensor of one element has no deviation: its value is a draw and is
skipped), then one JSON line with the count and the extremes.
"""

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "scripts")]

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from quality_seeds import CUT  # noqa: E402
from ucnerf_torch.config import parse_config  # noqa: E402
from ucnerf_torch.models.factory import init_params  # noqa: E402
from ucnerf_torch.utils.checkpoint_io import state_dict_from_jax  # noqa: E402
from ucnerf_tpu.config import parse_config as j_parse_config  # noqa: E402
from ucnerf_tpu.models.factory import init_params as j_init_params  # noqa: E402


def draws(seeds) -> dict:
    """{package: {name: [array per seed]}}."""
    argv = [a for a in CUT if a not in ("--steps_per_dispatch", "1")]
    cfg, jcfg = parse_config(argv), j_parse_config(argv)
    hw = (cfg.img_wh[1], cfg.img_wh[0])
    out = {"jax": {}, "port": {}}
    for seed in seeds:
        sd = state_dict_from_jax(jax.tree.map(np.asarray, j_init_params(
            jcfg, jax.random.PRNGKey(seed), hw)))
        tp = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
        for k in ("nerf", "mvs"):
            for n, v in sd[k].items():
                out["jax"].setdefault(f"{k}/{n}", []).append(np.asarray(v))
            for n, v in tp[k].items():
                out["port"].setdefault(f"{k}/{n}", []).append(v.numpy())
    return out


def main(seeds):
    d = draws(seeds)
    assert sorted(d["jax"]) == sorted(d["port"]), "state dicts differ"
    ratios, shifts = {}, {}
    for name, js in d["jax"].items():
        if js[0].size == 1:
            continue
        sj = float(np.mean([a.std() for a in js]))
        sp = float(np.mean([a.std() for a in d["port"][name]]))
        scale = max(sj, sp)
        if scale == 0:      # a constant initializer in both
            ratios[name] = 1.0
            shifts[name] = abs(float(np.mean(js)) - float(np.mean(
                d["port"][name])))
            continue
        ratios[name] = sp / sj if sj else float("inf")
        shifts[name] = abs(float(np.mean(js)) - float(np.mean(
            d["port"][name]))) / scale
    for name in ratios:
        if abs(ratios[name] - 1) > 0.1 or shifts[name] > 0.1:
            print(f"{name}: std ratio {ratios[name]:.3f}, "
                  f"mean shift {shifts[name]:.3f}")
    far = max(ratios, key=lambda n: abs(ratios[n] - 1))
    print(json.dumps(dict(
        seeds=seeds, tensors=len(d["jax"]), compared=len(ratios),
        ratio_min=min(ratios.values()), ratio_max=max(ratios.values()),
        farthest=far, shift_max=max(shifts.values()),
        off=sum(abs(r - 1) > 0.1 or shifts[n] > 0.1
                for n, r in ratios.items()))))


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [7, 8, 9])
