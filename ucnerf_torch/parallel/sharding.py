"""The multi-rank train steps and eval render: the port of
``ucnerf_tpu.parallel.sharding``.

- **Ray-DP** (``--parallel_mode rays``, the default): one scene per step,
  the serial step's objective.  Every rank runs the cascade and builds
  the same rays (the draws are a pure function of (seed, step), and the
  ray draw reads rank 0's confidence).  The ``[patches | uniform |
  sparse]`` batch is padded to a multiple of the group size by repeating
  its head; each rank renders its contiguous slice; the per-ray rgb and
  depth are gathered (``collectives.all_gather``) and the 5-term loss is
  computed on the gathered outputs.  ``--shard_mvs_views`` also splits the
  cascade's per-view work over the ranks (``mvs_views.py``).
- **Scene-DP** (``--parallel_mode scenes``): one scene per rank, N scenes
  a step; the loss and the metrics are the mean over the scenes.
- **Grid** (``--parallel_mode grid --mesh_shape S R --mesh_axes data
  rays``): S scenes a step, one per line of the scene axis, each scene's
  rays split R ways along the ray axis as in ray-DP; scene-DP's objective
  with S scenes.

In every mode the gradients are then averaged over all ranks
(``collectives.average_gradients``), so each rank applies the same
update and the replicated parameters stay equal.  Each rank feeds only
its own scene (the trainer picks its slot of the step's samples and
gathers it with ``data/device_store.py::gather_batch``), so nothing
stacks or shards a scene batch as the JAX package's ``stack_batches`` /
``shard_scene_batch`` do.

The sharded eval render is ``train/loop.py::make_eval_render`` given the
mesh: the view's context on every rank, the pixel tiles split into
contiguous blocks over all ranks (the fused MLP kernel on the card), the
frame gathered on every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ucnerf_torch.config import Config
from ucnerf_torch.parallel.collectives import (all_gather, average_gradients,
                                               broadcast_, mean_metrics)
from ucnerf_torch.parallel.mesh import Mesh
from ucnerf_torch.parallel.mvs_views import make_view_sharded_cascade
from ucnerf_torch.render.renderer import make_feat_ctx, render_rays
from ucnerf_torch.train.loop import (make_train_step, scene_inputs,
                                     scene_loss, scene_loss_terms)

MODES = ("rays", "scenes", "grid")


def check_mode(cfg: Config):
    """The JAX trainer's refusals of a multi-device configuration
    (``train.py:293-296``, ``:404-412``)."""
    if cfg.parallel_mode not in MODES:
        raise ValueError(f"unknown parallel_mode {cfg.parallel_mode!r}"
                         " (rays | scenes | grid)")
    if cfg.mvs_only and cfg.parallel_mode != "scenes":
        raise ValueError("--mvs_only has no rays to shard; use "
                         "--parallel_mode scenes for multi-chip")
    if cfg.parallel_mode == "grid" and len(cfg.mesh_shape) != 2:
        raise ValueError("--parallel_mode grid needs a 2D mesh, "
                         f"e.g. --mesh_shape 2 4 --mesh_axes data "
                         f"rays (got mesh_shape={cfg.mesh_shape})")


def scenes_per_step(cfg: Config, mesh: Mesh) -> int:
    """Scenes of one step: 1 (rays), every rank (scenes), the scene
    axis (grid)."""
    if cfg.parallel_mode == "scenes":
        return mesh.size
    if cfg.parallel_mode == "grid":
        return mesh.shape[0]
    return 1


def scene_slot(cfg: Config, mesh: Mesh) -> int:
    """Which of the step's scenes this rank trains."""
    if cfg.parallel_mode == "scenes":
        return mesh.rank
    if cfg.parallel_mode == "grid":
        return mesh.coord(mesh.axes[0])
    return 0


def shard_rays(rays, n: int, n_dev: int, r: int):
    """Rank ``r``'s contiguous slice of a ray batch of ``n`` rays padded
    to a multiple of ``n_dev`` by repeating its head; leaves without a
    leading ray axis stay whole."""
    per = -(-n // n_dev)
    n_pad = per * n_dev

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if torch.is_tensor(x) and x.dim() >= 1 and x.shape[0] == n:
            if n_pad > n:
                x = torch.cat([x, x[:n_pad - n]])
            return x[r * per:(r + 1) * per]
        return x
    return one(rays)


def ray_sharded_loss(cfg: Config, group, mvs_apply_for=None):
    """One scene's loss with its rays split over ``group``:
    ``loss_fn(nerf, mvs, batch, draws)`` -> (loss, metrics), equal on
    every rank of the group.  ``mvs_apply_for(mvs)`` gives the cascade
    forward (None: ``mvs`` itself)."""
    n_dev, r = dist.get_world_size(group), dist.get_rank(group)

    def agree(conf):
        return broadcast_(conf.contiguous(), group)

    def loss_fn(nerf, mvs, batch, draws):
        mvs_apply = None if mvs_apply_for is None else mvs_apply_for(mvs)
        imgs, mvs_out, confidence, rays = scene_inputs(
            cfg, mvs, batch, draws, train=True, mvs_apply=mvs_apply,
            agree=agree)
        n = rays["rays_o"].shape[0]
        feat_ctx = make_feat_ctx(mvs_out, confidence, imgs[1:],
                                 batch["w2cs"][1:], batch["intrinsics"][1:])
        rgb, depth = render_rays(nerf, shard_rays(rays, n, n_dev, r),
                                 feat_ctx, batch["w2cs"][0],
                                 white_bkgd=cfg.white_bkgd,
                                 fast=cfg.fast_featurization)
        rgb = all_gather(rgb, group)[:n]
        depth = all_gather(depth, group)[:n]
        return scene_loss_terms(cfg, batch, rgb, depth, rays, mvs_out)

    return loss_fn


def parallel_loss(cfg: Config, mesh: Mesh):
    """This rank's ``loss_fn(nerf, mvs, batch, draws)`` -> (loss to
    differentiate, metrics of the whole step) for ``cfg.parallel_mode``;
    ``batch`` and ``draws`` are this rank's scene's."""
    check_mode(cfg)
    world = mesh.group()
    if cfg.parallel_mode == "rays":
        views = ((lambda mvs: make_view_sharded_cascade(mvs, world))
                 if cfg.shard_mvs_views else None)
        return ray_sharded_loss(cfg, world, views)
    if cfg.parallel_mode == "scenes":
        def one(nerf, mvs, batch, draws):
            return scene_loss(cfg, nerf, mvs, batch, draws)
    else:
        one = ray_sharded_loss(cfg, mesh.group(mesh.axes[1]))

    def loss_fn(nerf, mvs, batch, draws):
        loss, metrics = one(nerf, mvs, batch, draws)
        return loss, mean_metrics(metrics, world)

    return loss_fn


def make_parallel_train_step(cfg: Config, schedule, mesh: Mesh):
    """The multi-rank ``train_step(state, batch, draws)`` of
    ``cfg.parallel_mode``: ``train/loop.py::make_train_step`` with
    ``parallel_loss`` and the gradients averaged over every rank."""
    return make_train_step(
        cfg, schedule, loss_fn=parallel_loss(cfg, mesh),
        reduce_grads=lambda params: average_gradients(params, mesh.group()))
