"""Train UC-NeRF with the port: the serial, host-fed, single-device loop
of the JAX package's ``train.py``.

    python -m ucnerf_torch.train --dataset_name synthetic --img_wh 320 256 \
        --view_num 7 --stop_after_steps 12 --save_params params.npz

Every ``Config`` flag parses as it does for ``train.py``; ``--mvs_only``
(cascade boot), the full objective and ``--finetune`` (cascade frozen) are
the three phases.  Two flags belong to this entry point only:
``--device`` (a torch device; the default is the card, ``--device cpu``
runs on the CPU) and ``--save_params out.npz`` (the trained weights in the
JAX package's ``'/'``-keyed layout, which ``--ckpt`` of this trainer, of
``ucnerf_torch.serve`` and of the JAX package's CLIs loads).

Output, one JSON object per line: per step ``{"step", "epoch", <loss
terms>, "lr", "ms"}`` (``step`` counts the updates made, ``lr`` is the one
the update used, ``ms`` the synchronized step time); a validation frame
``{"val_step", "val_psnr", "val_ms"}`` every ``--val_every_epochs`` epochs
and at the end; then ``{"steps", "epochs", "wall_s", "median_step_ms",
"rays_per_s", "val_psnr", "params"}``.

Run randomness is a pure function of ``--seed``: the epoch shuffle of
(seed, epoch), the sample draws of (seed, epoch, index) through the
dataset's ``set_epoch``, and the ray draws of (seed, step).  The port runs
one step per host dispatch (``--steps_per_dispatch`` is not read).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ucnerf_torch.config import Config, parse_config
from ucnerf_torch.data import build_dataset
from ucnerf_torch.kernels.fused_mlp import FusedNeRFMLP
from ucnerf_torch.models.factory import create_models
from ucnerf_torch.ops.rays import draw_train_randomness
from ucnerf_torch.render.serving import to_device_batch
from ucnerf_torch.train.loop import (TrainState, make_eval_render,
                                     make_lr_schedule, make_optimizer,
                                     make_train_step, unnormalize)
from ucnerf_torch.train.losses import img2mse, mse2psnr
from ucnerf_torch.utils import checkpoint_io
from ucnerf_torch.utils.platform import resolve_device


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The ray draws' generator for one step: seeded by a pure function of
    (seed, step), so a run's draws do not depend on its history."""
    state = np.random.SeedSequence([seed % 2 ** 32, 0, step]).generate_state(1)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def validate(cfg: Config, nerf, mvs, sample, device) -> dict:
    """One validation frame through the eval render, the MLP packed anew
    for the fused kernel from the current weights."""
    H, W = np.asarray(sample["images"]).shape[1:3]
    render = make_eval_render(cfg, FusedNeRFMLP(nerf), mvs, (H, W))
    batch = to_device_batch(sample, device)
    _sync(device)
    t0 = time.perf_counter()
    rgb, _, _ = render(batch)
    psnr = float(mse2psnr(img2mse(rgb, unnormalize(batch["images"][0]))))
    return {"val_psnr": psnr, "val_ms": (time.perf_counter() - t0) * 1e3}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    parser.add_argument("--save_params", default=None,
                        help="write the trained params to this .npz")
    ns, rest = parser.parse_known_args(argv)
    cfg = parse_config(rest)
    if cfg.mvs_only and cfg.finetune is not None:
        raise ValueError("--mvs_only trains only the MVS net; --finetune "
                         "freezes it: pick one")
    if int(np.prod(cfg.mesh_shape)) > 1:
        raise NotImplementedError("ucnerf_torch.train runs on one device "
                                  "(--mesh_shape)")
    dev = resolve_device(ns.device)

    train_ds = build_dataset(cfg, "train")
    val_sample = build_dataset(cfg, "val")[0]
    nerf, mvs = create_models(cfg, dev, checkpoint_io.load_params(cfg, dev))
    if cfg.eval:
        print(json.dumps({"val_step": 0,
                          **validate(cfg, nerf, mvs, val_sample, dev)}))
        return {}

    state = TrainState(nerf, mvs, make_optimizer(cfg, nerf, mvs))
    schedule = make_lr_schedule(cfg, len(train_ds))
    train_step = make_train_step(cfg, schedule)
    W, H = train_ds.img_wh
    draw_shape = dict(H=H, W=W, patch_size=cfg.patch_size,
                      patch_num=cfg.patch_num, n_uniform=cfg.n_uniform_rays,
                      n_rays=cfg.n_train_rays, n_samples=cfg.N_samples)

    step_ms = []
    t_all = time.perf_counter()
    epoch = 0
    stop = False
    for epoch in range(cfg.num_epochs):
        train_ds.set_epoch(epoch)
        order = np.random.default_rng(np.random.SeedSequence(
            [cfg.seed % 2 ** 32, 1 + epoch])).permutation(len(train_ds))
        for idx in order:
            batch = to_device_batch(train_ds[int(idx)], dev)
            draws = None if cfg.mvs_only else draw_train_randomness(
                step_generator(cfg.seed, state.step, dev), **draw_shape)
            lr = schedule(state.step)
            _sync(dev)
            t0 = time.perf_counter()
            metrics = train_step(state, batch, draws)
            m = {k: float(v) for k, v in metrics.items()}
            step_ms.append((time.perf_counter() - t0) * 1e3)
            print(json.dumps({"step": state.step, "epoch": epoch, **m,
                              "lr": lr, "ms": step_ms[-1]}), flush=True)
            stop = bool(cfg.stop_after_steps
                        and state.step >= cfg.stop_after_steps)
            if stop:
                break
        if stop:
            break
        if ((epoch + 1) % cfg.val_every_epochs == 0
                and epoch + 1 < cfg.num_epochs):
            print(json.dumps({"val_step": state.step,
                              **validate(cfg, nerf, mvs, val_sample, dev)}))
    wall = time.perf_counter() - t_all

    val = validate(cfg, nerf, mvs, val_sample, dev)
    print(json.dumps({"val_step": state.step, **val}))
    if ns.save_params:
        checkpoint_io.save_params_npz(
            checkpoint_io.jax_params_from_state_dict(
                {"nerf": nerf.state_dict(), "mvs": mvs.state_dict()}),
            ns.save_params)
    median = float(np.median(step_ms)) if step_ms else None
    summary = {"steps": state.step, "epochs": epoch + 1, "wall_s": wall,
               "median_step_ms": median,
               "rays_per_s": (cfg.n_train_rays / median * 1e3
                              if median and not cfg.mvs_only else None),
               "val_psnr": val["val_psnr"], "params": ns.save_params}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
