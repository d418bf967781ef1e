"""Train the port's three-phase lifecycle on the card and hold each phase's
final validation to the JAX package's quality record.

The chain is the one ``README.md`` gives for ``python -m
ucnerf_torch.train``, at the operating point of the JAX package's
chained run (``BASELINE.md``, round-5 results): the synthetic scene at
320x256 with 7 views, the ``train_scared`` hyperparameters, store-fed,
seed 7 (``--seed``), the f32 cascade and the bf16 MLP (each the
default), 200 steps an epoch:

    boot    --mvs_only                                      10 epochs
    full    --ckpt <boot's last> --ckpt_params_only         30 epochs
    refine  --finetune synth0 --ckpt <full's last>
            --ckpt_params_only                               6 epochs

Each phase runs the trainer as a process of its own.  A phase that has a
checkpoint of its own in the run directory resumes from the newest one
(``--ckpt`` without ``--ckpt_params_only``), so a phase can be split over
several calls:

    python3 chip_quality.py                          # every phase not done
    python3 chip_quality.py --phases boot full --until 3000
    python3 chip_quality.py --phases full refine     # full from its 3000

``--until N`` stops the last phase named at step N with
``--stop_after_steps`` (a checkpoint and no validation, as a killed run).
The run directory is ``--basedir`` (default ``chiprun_out/quality``,
beside ``chip_smoke.py``'s output).  When it is empty and ``--carry``
(default ``quality_carry``) exists, the carried directory is copied into
it first: a copy of an earlier call's run directory, for a machine that
starts each call from a fresh copy of the repository without it.
Checkpoints that no later segment needs are deleted as a phase ends: a
done phase keeps its last ``params.npz``, an unfinished one its last
checkpoint.

Output: one JSON line per segment (steps, the trainer's loop seconds, the
process's seconds, steps/s, median ms/step, every validation), then, on
the last line, every phase's totals, final validation and its band: PSNR
no more than 1.0 dB below the JAX package's, SSIM no more than 0.015
below, abs_rel no more than 1.25x.  ``quality.json`` in the run directory
keeps every segment.  A missed band is reported, not fatal; a phase that
fails, or a validation that is not finite, exits non-zero.  ``--seed``
(default 7) seeds every phase: give each seed a ``--basedir`` (and
``--carry``) of its own.  ``--extra`` appends flags to every trainer call
(``--extra "--device cpu ..."`` for a small run on the CPU).
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

import torch

PHASES = {  # name: (epochs, extra flags, the phase it starts from)
    "boot": (10, ["--mvs_only"], None),
    "full": (30, [], "boot"),
    "refine": (6, ["--finetune", "synth0"], "full"),
}
STEPS_PER_EPOCH = 200
BASE = ["--preset", "train_scared", "--dataset_name", "synthetic",
        "--img_wh", "320", "256", "--view_num", "7",
        "--samples_per_scene", str(STEPS_PER_EPOCH)]
# the JAX package's chained run (BASELINE.md, round 5): final validation
JAX_QUALITY = {"boot": {"abs_rel": 0.0812},
               "full": {"psnr": 26.59, "ssim": 0.957, "abs_rel": 0.0387},
               "refine": {"psnr": 27.38, "ssim": 0.966, "abs_rel": 0.0371}}
BAND = {"psnr": ("min", -1.0), "ssim": ("min", -0.015),
        "abs_rel": ("max", 1.25)}


def ckpts(basedir: str, phase: str) -> list:
    d = os.path.join(basedir, phase, "ckpts")
    if not os.path.isdir(d):
        return []
    return sorted((os.path.join(d, n) for n in os.listdir(d)
                   if n.startswith("step_")),
                  key=lambda p: int(p.rsplit("_", 1)[1]))


def step_of(path: str) -> int:
    return int(path.rsplit("_", 1)[1])


def in_band(phase: str, val: dict) -> dict:
    out = {}
    for k, ref in JAX_QUALITY[phase].items():
        kind, x = BAND[k]
        limit = ref + x if kind == "min" else ref * x
        got = val.get(k, float("nan"))
        out[k] = dict(port=got, jax=ref, limit=limit,
                      ok=bool(got >= limit if kind == "min"
                              else got <= limit))
    return out


def prune(basedir: str, phase: str, done: bool) -> None:
    """Keep a done phase's last params.npz, an unfinished one's last
    checkpoint."""
    found = ckpts(basedir, phase)
    for path in found[:-1]:
        shutil.rmtree(path)
    if done and found:
        state = os.path.join(found[-1], "train_state.pt")
        if os.path.exists(state):
            os.remove(state)


def run_segment(phase: str, basedir: str, until, extra: list,
                seed: int = 7) -> dict:
    epochs, flags, parent = PHASES[phase]
    own = ckpts(basedir, phase)
    argv = [*BASE, "--seed", str(seed), "--num_epochs", str(epochs), *flags,
            "--basedir", basedir, "--expname", phase]
    if own:
        start = step_of(own[-1])
        argv += ["--ckpt", own[-1]]
    else:
        start = 0
        if parent is not None:
            found = ckpts(basedir, parent)
            if not found:
                raise RuntimeError(f"phase {phase} needs phase {parent}'s "
                                   f"checkpoint in {basedir}")
            argv += ["--ckpt", found[-1], "--ckpt_params_only"]
    if until is not None:
        argv += ["--stop_after_steps", str(until)]
    argv += extra
    os.makedirs(os.path.join(basedir, phase), exist_ok=True)
    log = os.path.join(basedir, phase, f"stdout_from_{start:08d}.txt")
    t0 = time.perf_counter()
    with open(log, "w") as out:
        proc = subprocess.run([sys.executable, "-m", "ucnerf_torch.train",
                               *argv], stdout=out, stderr=subprocess.PIPE,
                              text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"phase {phase} failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    lines = [json.loads(ln) for ln in open(log) if ln.startswith("{")]
    summary = lines[-1]
    vals = [ln for ln in lines if "val_step" in ln]
    steps = summary["steps"] - start
    seg = dict(phase=phase, argv=argv, start_step=start,
               end_step=summary["steps"], done=not summary["stopped"],
               loop_s=summary["wall_s"], process_s=seconds,
               steps_per_s=steps / summary["wall_s"],
               median_step_ms=summary["median_step_ms"],
               validations=[{k: v for k, v in ln.items()
                             if not isinstance(v, dict)} for ln in vals],
               final=summary["val"], stderr_tail=proc.stderr[-2000:])
    for v in seg["validations"]:
        metrics = [v[k] for k in ("psnr", "ssim", "abs_rel") if k in v]
        if not metrics or not all(math.isfinite(x) for x in metrics):
            raise RuntimeError(f"phase {phase}: validation not finite: {v}")
    prune(basedir, phase, seg["done"])
    return seg


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def totals(segments: list) -> dict:
    out = {}
    for phase in PHASES:
        segs = [s for s in segments if s["phase"] == phase]
        if not segs:
            continue
        loop = sum(s["loop_s"] for s in segs)
        steps = segs[-1]["end_step"] - segs[0]["start_step"]
        last = segs[-1]
        out[phase] = dict(steps=last["end_step"], done=last["done"],
                          calls=len(segs), loop_s=loop,
                          process_s=sum(s["process_s"] for s in segs),
                          steps_per_s=steps / loop,
                          final=last["final"],
                          band=(in_band(phase, last["final"])
                                if last["done"] else None))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", nargs="+", default=list(PHASES),
                        choices=list(PHASES))
    parser.add_argument("--until", type=int, default=None)
    parser.add_argument("--basedir", default="chiprun_out/quality")
    parser.add_argument("--carry", default="quality_carry")
    parser.add_argument("--extra", default="")
    parser.add_argument("--seed", type=int, default=7)
    args = parser.parse_args(argv)
    device = dict(card=card(), torch=torch.__version__,
                  # the trainer sets neither: PyTorch's defaults
                  tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
                  tf32_cudnn=torch.backends.cudnn.allow_tf32)
    print(json.dumps(dict(device=device)), flush=True)
    if (not os.path.isdir(args.basedir) or not os.listdir(args.basedir)) \
            and os.path.isdir(args.carry):
        shutil.copytree(args.carry, args.basedir, dirs_exist_ok=True)
    record = os.path.join(args.basedir, "quality.json")
    segments = (json.load(open(record))["segments"]
                if os.path.exists(record) else [])
    for i, phase in enumerate(args.phases):
        last = i == len(args.phases) - 1
        if any(s["phase"] == phase and s["done"] for s in segments):
            continue
        seg = run_segment(phase, args.basedir, args.until if last else None,
                          shlex.split(args.extra), args.seed)
        segments.append(seg)
        with open(record, "w") as fh:
            json.dump(dict(device=device, segments=segments), fh, indent=1)
        print(json.dumps({k: v for k, v in seg.items()
                          if k not in ("argv", "stderr_tail")}), flush=True)
        if not seg["done"]:
            break
    print(json.dumps(dict(device=device, phases=totals(segments))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
