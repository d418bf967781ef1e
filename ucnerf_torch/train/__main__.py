"""Train UC-NeRF with the port: the serial single-device path of the JAX
package's ``train.py::main``.

    python -m ucnerf_torch.train --preset train_scared --datadir data/scared
    python -m ucnerf_torch.train --preset train_hamlyn --datadir data/hamlyn
    python -m ucnerf_torch.train --dataset_name synthetic --img_wh 320 256 \
        --view_num 7 --num_epochs 30
    python -m ucnerf_torch.train ... --ckpt logs/scared/ckpts/step_00005000
    python -m ucnerf_torch.train ... --eval --ckpt ucnerf.tar

Every ``Config`` flag parses as it does for ``train.py``; ``--mvs_only``
(cascade boot), the full objective and ``--finetune`` (cascade frozen) are
the three phases.  ``--ckpt`` takes a native checkpoint directory (written
here: a full resume of weights, Adam's moments and step, or with
``--ckpt_params_only`` its weights alone with a fresh optimizer at step 0,
the hand-off from one phase to the next), a ``'/'``-keyed params ``.npz``,
or a reference ``ucnerf.tar`` / ``casmvsnet.ckpt`` / ``.pth``.  ``--eval``
validates the loaded weights over the val split and exits.

Checkpoints go to ``<basedir>/<expname>/ckpts/step_XXXXXXXX/`` every 5000
steps (``--keep_ckpts`` prunes), at ``--stop_after_steps`` (which then
exits with no final validation, as a killed run would) and at the end.
Validation covers the whole val split every ``--val_every_epochs`` epochs
and once more at the end, and writes ``test_results/rgb_evaluation.txt``
(``mvs_evaluation.txt`` under ``--mvs_only``) and, per ``--val_panels
all|final|none``, a PNG panel per view (``final``: at the last validation
only; ``--eval`` counts as one).  With ``--device_dataset``
(the default) the train scenes sit on the device and each step's batch is
gathered there (``data/device_store.py``); a thread builds the next
samples' host payloads while the step runs.  ``--profile_dir`` traces the
step that takes the count from 10 to 11.  Metrics go to
``<basedir>/<expname>/tb/metrics.jsonl`` every 50 steps.

Three flags belong to this entry point only: ``--device`` (a torch
device; the default is the card, ``--device cpu`` runs on the CPU),
``--save_params out.npz`` (the trained weights in the JAX package's
``'/'``-keyed layout) and ``--deterministic`` (deterministic kernels,
``utils/platform.py::deterministic_kernels``: on the card a resume equals
an uninterrupted run bit for bit only with it).  ``--debug_nans`` turns on
autograd's anomaly mode and raises FloatingPointError at the first step
whose loss or any gradient is not finite, before its update.

Output, one JSON object per line: per step ``{"step", "epoch", <loss
terms>, "lr", "ms"}`` (``step`` counts the updates made, ``lr`` is the one
the update used, ``ms`` the synchronized step time); per validation
``{"val_step", "views", "ms_per_view", <metrics>}``; per checkpoint
``{"checkpoint", "seconds"}``; then ``{"steps", "epochs", "wall_s",
"median_step_ms", "rays_per_s", "val", "params", "ckpt", "stopped"}``.

Run randomness is a pure function of ``--seed``: the epoch shuffle of
(seed, epoch), the sample draws of (seed, epoch, index) through the
dataset's ``set_epoch``, and the ray draws of (seed, step), or of (seed,
step, scene slot) when a step trains several scenes.  The port runs one
step per dispatch (``--steps_per_dispatch`` is not read), so a resume
starts at epoch ``step // steps_per_epoch`` and skips ``step %
steps_per_epoch`` steps of its shuffle: a run stopped and resumed equals
an uninterrupted one.

Multi-rank (``--mesh_shape`` with more than one rank): the entry point
spawns one process per rank (``parallel/launch.py``) and each runs this
trainer with its ``Mesh``.  ``--parallel_mode rays`` (default) trains one
scene a step with its rays split over the ranks; ``scenes`` one scene per
rank; ``grid`` (``--mesh_shape S R --mesh_axes data rays``) S scenes with
their rays split R ways (``parallel/sharding.py``); ``--shard_mvs_views``
splits ray-DP's cascade over the views.  The scene-batched modes take the
epoch's shuffle in groups of their scene count and skip the short tail.
Every rank builds the dataset and the store and loads ``--ckpt``; rank 0
alone prints, writes metrics, panels and checkpoints (the ranks wait for
each save).  Validation and ``--eval`` render through the sharded eval
render.  The step lines carry the collectives' milliseconds and the
summary the mesh, its world size and backend.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

from ucnerf_torch.config import Config, parse_config
from ucnerf_torch.data import build_dataset
from ucnerf_torch.data.device_store import (build_store, gather_batch,
                                            sample_indices, store_nbytes)
from ucnerf_torch.kernels.fused_mlp import require_kernel_shape
from ucnerf_torch.models.factory import create_appearance, create_models
from ucnerf_torch.ops.rays import draw_train_randomness
from ucnerf_torch.parallel import collectives, launch
from ucnerf_torch.parallel.mesh import (check_mesh, current_mesh,
                                        is_main_rank, mesh_size)
from ucnerf_torch.parallel.sharding import (check_mode,
                                            make_parallel_train_step,
                                            scene_slot, scenes_per_step)
from ucnerf_torch.render.serving import to_device_batch
from ucnerf_torch.train.loop import (TrainState, make_lr_schedule,
                                     make_optimizer, make_train_step,
                                     objective)
from ucnerf_torch.train.validation import Validator
from ucnerf_torch.utils import checkpoint_io
from ucnerf_torch.utils.platform import (deterministic_kernels,
                                         resolve_device)
from ucnerf_torch.utils.prefetch import ThreadPrefetcher
from ucnerf_torch.utils.profiling import RateMeter, trace
from ucnerf_torch.utils.writer import MetricWriter

CKPT_EVERY = 5000
WRITE_EVERY = 50
PROFILE_STEP = 10


def step_generator(seed: int, step: int, device,
                   slot=None) -> torch.Generator:
    """The ray draws' generator for one step: seeded by a pure function of
    (seed, step), and of the scene slot when a step trains several scenes,
    so a run's draws do not depend on its history."""
    entropy = [seed % 2 ** 32, 0, step] + ([] if slot is None else [slot])
    state = np.random.SeedSequence(entropy).generate_state(1)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _emit(**line):
    if is_main_rank():
        print(json.dumps(line), flush=True)


def validate(validator: Validator, nerf, mvs, step: int, device,
             final: bool) -> dict:
    """One validation over the val split, timed to its last metric and
    panel, and its JSON line."""
    _sync(device)
    t0 = time.perf_counter()
    metrics = validator(nerf, mvs, step, final)
    ms = (time.perf_counter() - t0) * 1e3
    n = len(validator.val_ds)
    _emit(val_step=step, views=n, ms_per_view=ms / n, **metrics,
          **(validator.panels or {}))
    return metrics


def save(ckpt_dir: str, state: TrainState, cfg: Config) -> str:
    """Rank 0 writes the checkpoint; the other ranks wait for it."""
    t0 = time.perf_counter()
    path = checkpoint_io.save_checkpoint(ckpt_dir, state, state.step,
                                         keep=cfg.keep_ckpts)
    _emit(checkpoint=path, seconds=time.perf_counter() - t0)
    return path


def sample_source(cfg: Config, train_ds, device):
    """(fetch(idx) -> host payload, to_batch(payload) -> device batch):
    index payloads gathered from the device store with ``--device_dataset``,
    else whole host samples uploaded."""
    if not cfg.device_dataset:
        return (lambda j: train_ds[j],
                lambda p: to_device_batch(p, device))
    store = build_store(train_ds, device)
    _emit(store_mb=store_nbytes(store) / 1e6, scans=len(train_ds.scans))
    return (lambda j: sample_indices(train_ds, j),
            lambda p: gather_batch(store, to_device_batch(p, device)))


def main(argv=None, timeout=None) -> dict:
    """Parse ``argv`` and train (or ``--eval``).  With more than one rank
    in ``--mesh_shape`` this spawns the ranks, each of which runs ``main``
    again with its mesh, and returns rank 0's summary; ``timeout`` (s)
    bounds the spawned run."""
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    parser.add_argument("--save_params", default=None,
                        help="write the trained params to this .npz")
    parser.add_argument("--deterministic", action="store_true",
                        help="deterministic kernels (exact resume on the "
                        "card, at a cost per step)")
    ns, rest = parser.parse_known_args(argv)
    cfg = parse_config(rest)
    if cfg.mvs_only and cfg.finetune is not None:
        raise ValueError("--mvs_only trains only the MVS net; --finetune "
                         "freezes it: pick one")
    mesh = current_mesh()
    if mesh_size(cfg.mesh_shape) > 1:
        check_mesh(cfg.mesh_shape, cfg.mesh_axes)
        check_mode(cfg)
        if mesh is None:
            return launch.run_ranks(
                "ucnerf_torch.train.__main__:_rank_main", (argv,),
                cfg.mesh_shape, cfg.mesh_axes,
                resolve_device(ns.device).type, timeout=timeout)[0]
    with deterministic_kernels(ns.deterministic):
        return run(cfg, ns)


def _rank_main(mesh, argv) -> dict:
    return main(argv)


def run(cfg: Config, ns: argparse.Namespace) -> dict:
    """The run ``main`` parsed: ``--eval``, or training from ``--seed`` or
    ``--ckpt`` to the end or to ``--stop_after_steps``; on this rank of
    its mesh in a multi-rank run."""
    mesh = current_mesh()
    dev = resolve_device(ns.device) if mesh is None else mesh.device

    params = checkpoint_io.load_params(cfg, dev)
    nerf, mvs = create_models(cfg, dev, params)
    appearance = create_appearance(cfg, dev, params)
    require_kernel_shape(nerf)      # before a long run, not at validation
    if cfg.ckpt:
        _emit(restored=cfg.ckpt, params_only=cfg.ckpt_params_only)
    validator = Validator(cfg, dev, mesh)
    mesh_info = ({} if mesh is None else dict(
        mesh_shape=list(mesh.shape), mesh_axes=list(mesh.axes),
        world_size=mesh.size, backend=mesh.backend,
        parallel_mode=cfg.parallel_mode))
    if cfg.eval:
        summary = {"eval": cfg.ckpt,
                   "val": validate(validator, nerf, mvs, 0, dev, final=True),
                   **mesh_info}
        _emit(**summary)
        return summary

    train_ds = build_dataset(cfg, "train")
    n_train = len(train_ds)
    # scenes a step, and which of them this rank trains (None: one scene
    # a step, the serial draws)
    n_scenes = 1 if mesh is None else scenes_per_step(cfg, mesh)
    slot = None if n_scenes == 1 else scene_slot(cfg, mesh)
    if n_train < n_scenes:
        raise ValueError(
            f"{n_train} train samples < {n_scenes} scenes/step; "
            "raise --samples_per_scene or shrink --mesh_shape")
    steps_per_epoch = n_train // n_scenes
    state = TrainState(nerf, mvs, make_optimizer(cfg, nerf, mvs, appearance),
                       objective=objective(cfg), appearance=appearance)
    if (cfg.ckpt and not cfg.ckpt_params_only
            and os.path.isdir(cfg.ckpt)):
        checkpoint_io.load_checkpoint(cfg.ckpt, state)
    start_epoch, skip = divmod(state.step, steps_per_epoch)
    if state.step:
        _emit(resumed=state.step, epoch=start_epoch, skip=skip)
        if dev.type == "cuda" and not ns.deterministic and is_main_rank():
            print("ucnerf_torch.train: resuming on the card's default "
                  "kernels, so the resumed steps will not equal an "
                  "uninterrupted run bit for bit (--deterministic makes "
                  "them equal)", file=sys.stderr)
    schedule = make_lr_schedule(cfg, n_train)
    train_step = (make_train_step(cfg, schedule) if mesh is None
                  else make_parallel_train_step(cfg, schedule, mesh))
    fetch, to_batch = sample_source(cfg, train_ds, dev)
    W, H = train_ds.img_wh
    draw_shape = dict(H=H, W=W, patch_size=cfg.patch_size,
                      patch_num=cfg.patch_num, n_uniform=cfg.n_uniform_rays,
                      n_rays=cfg.n_built_rays, n_samples=cfg.N_samples)
    ckpt_dir = os.path.join(cfg.basedir, cfg.expname, "ckpts")
    writer = (MetricWriter(os.path.join(cfg.basedir, cfg.expname, "tb"),
                           use_wandb=cfg.log) if is_main_rank() else None)
    meter = RateMeter()

    step_ms = []
    t_all = time.perf_counter()
    epoch = start_epoch
    stop = False
    ckpt = None
    last_saved = -1
    for epoch in range(start_epoch, cfg.num_epochs):
        train_ds.set_epoch(epoch)
        order = np.random.default_rng(np.random.SeedSequence(
            [cfg.seed % 2 ** 32, 1 + epoch])).permutation(n_train)
        first = skip if epoch == start_epoch else 0
        # this rank's sample of each step: the step's group of n_scenes
        # samples of the shuffle, at this rank's slot
        mine = order[:steps_per_epoch * n_scenes].reshape(
            steps_per_epoch, n_scenes)[:, slot or 0]
        with ThreadPrefetcher((lambda i=i: fetch(int(i))
                               for i in mine[first:]), depth=2) as loader:
            for payload in loader:
                batch = to_batch(payload)
                draws = None if cfg.mvs_only else draw_train_randomness(
                    step_generator(cfg.seed, state.step, dev, slot),
                    **draw_shape)
                lr = schedule(state.step)
                profiled = (trace(cfg.profile_dir) if cfg.profile_dir
                            and state.step == PROFILE_STEP
                            and is_main_rank()
                            else contextlib.nullcontext())
                collectives.reset_stats()
                _sync(dev)
                t0 = time.perf_counter()
                with profiled:
                    m = {k: float(v) for k, v in
                         train_step(state, batch, draws).items()}
                step_ms.append((time.perf_counter() - t0) * 1e3)
                meter.update(cfg.n_built_rays * n_scenes)
                comm = ({} if mesh is None
                        else {"collectives": dict(collectives.STATS)})
                _emit(step=state.step, epoch=epoch, **m, lr=lr,
                      ms=step_ms[-1], **comm)
                if writer is not None and state.step % WRITE_EVERY == 0:
                    writer.write(state.step,
                                 {**{f"train/{k}": v for k, v in m.items()},
                                  "train/rays_per_s": meter.rate})
                if state.step % CKPT_EVERY == 0:
                    ckpt = save(ckpt_dir, state, cfg)
                    last_saved = state.step
                stop = bool(cfg.stop_after_steps
                            and state.step >= cfg.stop_after_steps)
                if stop:
                    break
        if stop:
            break
        if (epoch + 1) % cfg.val_every_epochs == 0:
            validate(validator, nerf, mvs, state.step, dev, final=False)
    wall = time.perf_counter() - t_all

    if state.step != last_saved:
        ckpt = save(ckpt_dir, state, cfg)
    val = (None if stop
           else validate(validator, nerf, mvs, state.step, dev, final=True))
    if writer is not None:
        writer.close()
    if ns.save_params and is_main_rank():
        checkpoint_io.save_params_npz(
            checkpoint_io.params_tree(nerf, mvs, appearance), ns.save_params)
    median = float(np.median(step_ms)) if step_ms else None
    summary = {"steps": state.step, "epochs": epoch + 1, "wall_s": wall,
               "median_step_ms": median,
               "rays_per_s": (cfg.n_built_rays * n_scenes / median * 1e3
                              if median and not cfg.mvs_only else None),
               "val": val, "params": ns.save_params, "ckpt": ckpt,
               "stopped": stop, **mesh_info}
    _emit(**summary)
    return summary


if __name__ == "__main__":
    main()
