"""Train the full phase of ``scripts/quality_seeds.py``'s cut point in both
packages from one state and on the same inputs, and read how far the
port's trajectory drifts from the JAX package's against how far the JAX
package's own drifts from a start that is as far off as the port's.

Setup: ``quality_seeds.CUT`` with ``--nerf_dtype float32``, the JAX
package's state after its ``--mvs_only`` boot phase (an orbax checkpoint,
``--boot``), the full phase's optimizer and LR schedule (30 epochs of 40
steps).  Every step of every run takes the same sample (the JAX trainer's
epoch order, host-fed) and the same ray draws: the JAX trainer's key
``fold_in(PRNGKey(seed), step)``, fed to the port as a ``TrainDraws``
(``tests/test_torch_train_rays.py::jax_train_draws``).  Runs:

- (i) the JAX step at XLA's default compile, from the boot state;
- (ii) the port's step (``ucnerf_torch.train.loop.make_train_step``) from
  the boot state carried in by ``utils/checkpoint_io.py``;
- (iii) the JAX step from the boot state plus seeded Gaussian noise
  (each tensor's noise scaled by ``s`` times the larger of its rms and
  the learning rate), ``s`` chosen so that (iii)'s median per-tensor
  distance to (i) after step 1 equals (ii)'s.

At steps 1, 10, 50, 100 and 200 it reads each loss term of that step and the
median and worst per-tensor relative distance ``|p - p_i| / |p_i|`` (L2
norms, in the JAX layout) of (ii) and (iii) to (i); after the last step
the validation PSNR / SSIM / abs_rel of each run's weights, all rendered
by the JAX package's validator (``train.py::Validator``), so that only the
weights differ.

Run from the repository root, with the JAX package on the CPU (about 35
minutes; one JAX step here takes 2.6-5 s):

    JAX_PLATFORMS=cpu python train.py <quality_seeds.CUT> --seed 7 \\
        --num_epochs 10 --mvs_only --nerf_dtype float32 \\
        --basedir runs/traj --expname boot
    JAX_PLATFORMS=cpu python scripts/trajectory_gaps.py \\
        --boot runs/traj/boot/ckpts/step_00000400 --out runs/traj

It prints one JSON line per recorded step and a last line with the
validations, the calibration and the rule's verdict (the rule stands in
``PERF.md`` §6: (ii) stays within 2x of (iii) at every recorded step).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts"),
                os.path.join(ROOT, "tests")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from quality_seeds import CUT  # noqa: E402
from test_torch_train_rays import jax_train_draws  # noqa: E402
from ucnerf_torch.config import parse_config  # noqa: E402
from ucnerf_torch.models.factory import create_models  # noqa: E402
from ucnerf_torch.render.serving import to_device_batch as t_batch  # noqa
from ucnerf_torch.train import loop as t_loop  # noqa: E402
from ucnerf_torch.utils.checkpoint_io import (params_tree,  # noqa: E402
                                              state_dict_from_jax)
from ucnerf_tpu.config import parse_config as j_parse_config  # noqa: E402
from ucnerf_tpu.data import build_dataset as j_build_dataset  # noqa: E402
from ucnerf_tpu.models.factory import create_models as j_models  # noqa
from ucnerf_tpu.models.factory import init_params as j_init  # noqa: E402
from ucnerf_tpu.train import loop as j_loop  # noqa: E402
from ucnerf_tpu.utils.checkpoint_io import load_params  # noqa: E402

SEED = 7
FULL_EPOCHS = 30
RECORD = (1, 10, 50, 100, 200)
TERMS = ("loss", "img_mse", "nerf_depth", "mvs", "smooth", "scaleinv")
# JAX first steps spent choosing (iii)'s noise scale
CALIBRATIONS = 4


def configs():
    argv = [*CUT, "--seed", str(SEED), "--num_epochs", str(FULL_EPOCHS),
            "--nerf_dtype", "float32"]
    return parse_config(argv), j_parse_config(argv)


def flat(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v, np.float64)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def distance(run: dict, ref: dict) -> dict:
    """Median and worst per-tensor |run - ref| / |ref| over the tensors
    of ``ref`` (L2 norms)."""
    d = {k: float(np.linalg.norm(run[k] - r) / max(np.linalg.norm(r),
                                                   1e-12))
         for k, r in ref.items()}
    worst = max(d, key=d.get)
    return dict(median=float(np.median(list(d.values()))), worst=d[worst],
                worst_tensor=worst)


class Feed:
    """The JAX trainer's samples and per-step keys (host-fed)."""

    def __init__(self, jcfg, cfg):
        self.jcfg, self.cfg = jcfg, cfg
        self.ds = j_build_dataset(jcfg, "train")
        self.key = jax.random.PRNGKey(jcfg.seed)
        self.W, self.H = self.ds.img_wh
        self._cache = {}

    def __call__(self, step: int):
        """(numpy sample, JAX key) of global step ``step`` (0-based)."""
        n = len(self.ds)
        epoch, i = divmod(step, n)
        if epoch not in self._cache:
            self._cache = {epoch: np.random.default_rng(
                np.random.SeedSequence([self.jcfg.seed % 2 ** 32,
                                        1 + epoch])).permutation(n)}
            self.ds.set_epoch(epoch)
        idx = int(self._cache[epoch][i])
        return self.ds[idx], jax.random.fold_in(self.key, step)

    def draws(self, key):
        c = self.cfg
        return jax_train_draws(key, H=self.H, W=self.W,
                               patch_size=c.patch_size,
                               patch_num=c.patch_num,
                               n_uniform=c.n_uniform_rays,
                               n_rays=c.n_built_rays, n_samples=c.N_samples)


def jax_run(jcfg, params, feed, steps, record):
    """Train the JAX step ``steps`` steps from ``params``: ({step: flat
    params}, {step: terms})."""
    nerf, mvs = j_models(jcfg)
    tx = j_loop.make_optimizer(jcfg, steps_per_epoch=len(feed.ds))
    step_fn = j_loop.make_train_step(jcfg, nerf, mvs, tx)
    state = j_loop.TrainState(params, tx.init(params),
                              jnp.zeros((), jnp.int32))
    snaps, terms = {}, {}
    for s in range(steps):
        sample, key = feed(s)
        state, metrics = step_fn(state, j_loop.to_device_batch(sample), key)
        if s + 1 in record:
            snaps[s + 1] = flat(state.params)
            terms[s + 1] = {k: float(metrics[k]) for k in TERMS}
    return snaps, terms, state.params


def port_run(cfg, params_np, feed, steps, record):
    nerf, mvs = create_models(cfg, "cpu", state_dict_from_jax(params_np))
    state = t_loop.TrainState(nerf, mvs, t_loop.make_optimizer(cfg, nerf,
                                                               mvs))
    step_fn = t_loop.make_train_step(cfg, t_loop.make_lr_schedule(
        cfg, len(feed.ds)))
    snaps, terms = {}, {}
    for s in range(steps):
        sample, key = feed(s)
        metrics = step_fn(state, t_batch(sample, "cpu"), feed.draws(key))
        if s + 1 in record:
            snaps[s + 1] = flat(params_tree(state.nerf, state.mvs))
            terms[s + 1] = {k: float(metrics[k]) for k in TERMS}
    return snaps, terms, params_tree(state.nerf, state.mvs)


def perturb(params, s: float, lr: float):
    rng = np.random.default_rng(0)

    def one(p):
        p = np.asarray(p, np.float32)
        scale = s * max(float(np.sqrt(np.mean(p.astype(np.float64) ** 2))),
                        lr)
        return jnp.asarray(p + scale * rng.standard_normal(p.shape)
                           .astype(np.float32))
    return jax.tree.map(one, params)


def validate(jcfg, params, out: str, name: str) -> dict:
    import train as j_train
    vcfg = jcfg.replace(basedir=out, expname=name, val_panels="none")
    nerf, mvs = j_models(vcfg)
    m = j_train.Validator(vcfg, nerf, mvs)(
        jax.tree.map(jnp.asarray, params), 0, final=True)
    return {k: float(m[k]) for k in ("psnr", "ssim", "abs_rel")}


def boot_params(jcfg, ckpt: str):
    H, W = jcfg.img_wh[1], jcfg.img_wh[0]
    shapes = jax.eval_shape(lambda: j_init(jcfg, jax.random.PRNGKey(
        jcfg.seed), (H, W)))
    target = jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), shapes)
    return jax.tree.map(jnp.asarray, load_params(ckpt, target))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--boot", required=True,
                    help="the JAX package's boot-phase orbax checkpoint")
    ap.add_argument("--out", default="runs/traj")
    ap.add_argument("--steps", type=int, default=max(RECORD),
                    help="fewer steps for a rehearsal")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    record = sorted({r for r in RECORD if r <= args.steps} | {args.steps})
    cfg, jcfg = configs()
    feed = Feed(jcfg, cfg)
    p0 = boot_params(jcfg, args.boot)
    p0_np = jax.tree.map(np.asarray, p0)

    ref, ref_terms, ref_final = jax_run(jcfg, p0, feed, args.steps, record)
    port, port_terms, port_final = port_run(cfg, p0_np, feed, args.steps,
                                            record)
    target = distance(port[1], ref[1])["median"]

    # (iii)'s noise scale: the relative noise s moves step 1's median gap
    # about in proportion, so a few secant steps in log space settle it
    s, tried = target, []
    for _ in range(CALIBRATIONS):
        snaps, _, _ = jax_run(jcfg, perturb(p0, s, jcfg.lrate), feed, 1,
                              {1})
        got = distance(snaps[1], ref[1])["median"]
        tried.append(dict(s=s, median=got))
        if abs(got / target - 1) < 0.02:
            break
        s *= target / got
    env, env_terms, env_final = jax_run(
        jcfg, perturb(p0, s, jcfg.lrate), feed, args.steps, record)

    ok = True
    for k in record:
        dp, de = distance(port[k], ref[k]), distance(env[k], ref[k])
        inside = (dp["median"] <= 2 * de["median"]
                  and dp["worst"] <= 2 * de["worst"])
        ok &= inside
        print(json.dumps(dict(step=k, port=dp, envelope=de, inside=inside,
                              terms=dict(jax=ref_terms[k],
                                         port=port_terms[k],
                                         envelope=env_terms[k]))),
              flush=True)
    val = {name: validate(jcfg, p, args.out, name) for name, p in (
        ("jax", ref_final), ("port", port_final), ("envelope", env_final))}
    print(json.dumps(dict(validation=val, noise_scale=s, calibration=tried,
                          steps=args.steps,
                          rule_holds=bool(ok), jax=jax.__version__,
                          torch=torch.__version__,
                          seconds=time.perf_counter() - t0)), flush=True)


if __name__ == "__main__":
    main()
