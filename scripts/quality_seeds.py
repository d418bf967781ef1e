"""Train the three-phase chain of ``chip_quality.py`` at a cut point in
either package, over several seeds, and hold the port's mean final
validation to the JAX package's.

The cut point keeps the operating widths of the JAX package's chained run
(``BASELINE.md``, round 5): the synthetic scene, V=7, 90 samples, the
cascade 48/32/8, the width-128 MLP at bf16, ``train_scared``'s lr and
6x6 patches, store-fed.  It cuts the image to 96x64 (both sides multiples
of 32, as the cascade needs), the rays per step to 12 patches + 68
uniform + 256 sparse-depth rays (756, an even ``--patch_num``) and the
length to ``SAMPLES`` steps an epoch, the phases keeping their 10:30:6
epochs: 400, 1,200 and 240 steps.  Only each phase's final validation
runs (``--val_every_epochs`` past the last epoch).  The JAX package runs
one step per dispatch (``--steps_per_dispatch 1``, which the port does
not read), as the port does.

Each phase is one process of the package's own CLI (``train.py`` for the
JAX package, ``python -m ucnerf_torch.train`` for the port), handed the
last checkpoint of the phase before with ``--ckpt_params_only``; a
seed's checkpoints are deleted when its chain ends.  The phases, the band
and the checkpoint hand-off are ``chip_quality.py``'s; this script
imports neither package.  It prints one JSON line per package,
seed and phase (``{"package", "device", "seed", "phase", "steps",
"seconds", "val"}``, ``val`` read from the phase's ``test_results/``),
and with both packages' lines, the verdict:

    # the JAX package on a CPU
    JAX_PLATFORMS=cpu python scripts/quality_seeds.py --package jax \\
        --seeds 7 8 9 --basedir runs/seeds > jax_seeds.jsonl
    # the port on the card (``--extra "--device cpu"`` on a CPU,
    # ``--extra=--deterministic`` on the card's deterministic kernels)
    python3 scripts/quality_seeds.py --package port --seeds 7 8 9 \\
        --basedir chiprun_out/seeds > port_seeds.jsonl
    # the verdict from both
    python scripts/quality_seeds.py --verdict jax_seeds.jsonl \\
        port_seeds.jsonl

The rule (fixed before any chain ran): for each phase and metric, the
port's mean over its seeds lies inside the band of the JAX package's mean
(PSNR no more than 1.0 dB below, SSIM no more than 0.015 below, abs_rel
no more than 1.25x, as ``chip_quality.py``'s band); each package's spread
(the standard deviation and the range over seeds) is reported beside.
``--verdict`` exits 0 whatever the verdict; a phase that fails, or a
validation that is not finite, exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shlex
import shutil
import subprocess
import sys
import time

SAMPLES = 40
CUT = ["--preset", "train_scared", "--dataset_name", "synthetic",
       "--img_wh", "96", "64", "--view_num", "7", "--batch_size", "500",
       "--patch_num", "12", "--n_depth_rays", "256",
       "--samples_per_scene", str(SAMPLES), "--val_every_epochs", "1000",
       "--steps_per_dispatch", "1"]
METRICS = {"boot": ("abs_rel",), "full": ("psnr", "ssim", "abs_rel"),
           "refine": ("psnr", "ssim", "abs_rel")}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# the chain's phases, its band and its checkpoints, as the full-size run's
from chip_quality import BAND, PHASES, ckpts, step_of  # noqa: E402


def cli(package: str) -> list:
    if package == "jax":
        return [sys.executable, os.path.join(ROOT, "train.py")]
    return [sys.executable, "-m", "ucnerf_torch.train"]


def run_phase(package: str, seed: int, phase: str, basedir: str,
              extra: list) -> dict:
    epochs, flags, parent = PHASES[phase]
    base = os.path.join(basedir, package, f"seed{seed}")
    argv = [*CUT, "--seed", str(seed), "--num_epochs", str(epochs), *flags,
            "--basedir", base, "--expname", phase]
    if parent is not None:
        argv += ["--ckpt", ckpts(base, parent)[-1], "--ckpt_params_only"]
    argv += extra
    os.makedirs(os.path.join(base, phase), exist_ok=True)
    t0 = time.perf_counter()
    with open(os.path.join(base, phase, "stdout.txt"), "w") as out:
        proc = subprocess.run([*cli(package), *argv], stdout=out,
                              stderr=subprocess.PIPE, text=True, cwd=ROOT)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{package} seed {seed} phase {phase} failed "
                           f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    name = "mvs_evaluation.txt" if phase == "boot" else "rgb_evaluation.txt"
    with open(os.path.join(base, phase, "test_results", name)) as fh:
        val = json.load(fh)
    if not all(math.isfinite(val[k]) for k in METRICS[phase]):
        raise RuntimeError(f"{package} seed {seed} phase {phase}: "
                           f"validation not finite: {val}")
    steps = step_of(ckpts(base, phase)[-1])
    device = "cpu" if package == "jax" else "card"
    if "--device" in extra:
        device = extra[extra.index("--device") + 1]
    return dict(package=package, device=device, seed=seed, phase=phase,
                steps=steps, seconds=seconds,
                val={k: val[k] for k in METRICS[phase]})


def _stats(xs: list) -> dict:
    mean = sum(xs) / len(xs)
    sd = (math.sqrt(sum((x - mean) ** 2 for x in xs) / (len(xs) - 1))
          if len(xs) > 1 else 0.0)
    return dict(mean=mean, sd=sd, min=min(xs), max=max(xs), n=len(xs))


def verdict(lines: list) -> dict:
    """The rule of the module's docstring over ``lines`` (both
    packages')."""
    out = {}
    for phase, metrics in METRICS.items():
        for m in metrics:
            vals = {p: [ln["val"][m] for ln in lines
                        if ln["package"] == p and ln["phase"] == phase]
                    for p in ("jax", "port")}
            if not vals["jax"] or not vals["port"]:
                continue
            jax, port = _stats(vals["jax"]), _stats(vals["port"])
            kind, x = BAND[m]
            limit = jax["mean"] + x if kind == "min" else jax["mean"] * x
            ok = (port["mean"] >= limit if kind == "min"
                  else port["mean"] <= limit)
            out[f"{phase}/{m}"] = dict(jax=jax, port=port, limit=limit,
                                       ok=bool(ok))
    return dict(verdict=out, all_in_band=(all(v["ok"] for v in out.values())
                                         if out else None))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--package", choices=("jax", "port"))
    parser.add_argument("--seeds", type=int, nargs="+", default=[7, 8, 9])
    parser.add_argument("--phases", nargs="+", default=list(PHASES),
                        choices=list(PHASES))
    parser.add_argument("--basedir", default="chiprun_out/seeds")
    parser.add_argument("--extra", default="",
                        help="flags appended to every trainer call")
    parser.add_argument("--verdict", nargs="+", metavar="JSONL",
                        help="files of this script's lines: print the "
                        "verdict over them and exit")
    args = parser.parse_args(argv)
    if args.verdict:
        lines = [json.loads(ln) for f in args.verdict for ln in open(f)
                 if ln.startswith('{"package"')]
        print(json.dumps(verdict(lines)), flush=True)
        return 0
    if args.package is None:
        parser.error("--package or --verdict")
    basedir = os.path.abspath(args.basedir)   # the trainer runs in ROOT
    lines = []
    for seed in args.seeds:
        for phase in args.phases:
            line = run_phase(args.package, seed, phase, basedir,
                             shlex.split(args.extra))
            lines.append(line)
            print(json.dumps(line), flush=True)
        for phase in args.phases:   # the hand-offs are done
            shutil.rmtree(os.path.join(basedir, args.package,
                                       f"seed{seed}", phase, "ckpts"),
                          ignore_errors=True)
    print(json.dumps(verdict(lines)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
