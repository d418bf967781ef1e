"""Configuration for ucnerf_torch.

A copy of ``ucnerf_tpu.config``: the same fields, defaults, presets and
flag parser, so one flag set drives both packages.  Fields that only the
JAX package reads (mesh, dispatch and compile-cache knobs) are kept so
that a flag line written for one package parses in the other; the port
ignores them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Config:
    # experiment / IO
    expname: str = "scared"
    basedir: str = "./logs/"
    datadir: str = "../../Datasets/"
    log: bool = False
    seed: int = 123456

    # data
    dataset_name: str = "scared"      # scared | hamlyn | finetune | synthetic
    imgScale_train: Optional[float] = None
    imgScale_test: Optional[float] = None
    img_wh: Tuple[int, ...] = ()      # synthetic-dataset render size (W H);
                                      # empty = the dataset default (64 32)
    img_downscale: float = 1.0
    pad: int = 0
    view_num: int = 5                 # V: 1 target + (V-1) source views
    n_scans: int = 1                  # synthetic dataset only

    # ray budget
    samples_per_scene: int = 200
    batch_size: int = 2000
    patch_size: int = 6
    patch_num: int = 50
    n_depth_rays: int = 1024
    N_samples: int = 90               # depth samples/ray; 3 cascade stages x 30

    # MLP
    netdepth: int = 6
    netwidth: int = 128
    multires: int = 10
    multires_views: int = 4
    skips: Tuple[int, ...] = (4,)
    net_type: str = "v0"

    # MVS cascade
    ndepths: Tuple[int, ...] = (48, 32, 8)
    depth_intervals_ratio: Tuple[int, ...] = (4, 2, 1)

    # training
    lrate: float = 6e-4
    num_epochs: int = 100
    lr_scheduler: str = "cosine"      # cosine | steplr | poly
    decay_step: Tuple[int, ...] = (8000, 18000, 25000)
    decay_gamma: float = 0.5
    warmup_epochs: int = 0
    chunk: int = 1024                 # eval render rays per tile
    eval_unroll: int = 16             # JAX package only (scan unroll)
    finetune: Optional[str] = None
    mvs_only: bool = False
    ckpt: Optional[str] = None
    ckpt_params_only: bool = False
    keep_ckpts: int = 0
    eval: bool = False
    stop_after_steps: int = 0

    # rendering
    use_color_volume: bool = False
    color_volume_depths: int = 48
    encode_a: bool = False
    N_vocab: int = 100
    N_a: int = 48
    perturb: float = 1.0
    use_viewdirs: bool = True
    raw_noise_std: float = 0.0
    white_bkgd: bool = False

    # loss weights
    w_nerf_depth: float = 0.05
    w_mvs: float = 0.05
    w_smooth: float = 0.05
    w_scaleinv: float = 0.008
    w_img: float = 5.0

    # parallelism (JAX package only for now)
    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axes: Tuple[str, ...] = ("data",)
    parallel_mode: str = "rays"
    shard_mvs_views: bool = False
    steps_per_dispatch: int = 16
    val_every_epochs: int = 2
    val_panels: str = "final"         # all | final | none

    # stratified-jitter the eval-time depth candidates (off: deterministic
    # midpoint renders)
    eval_jitter: bool = False
    device_dataset: bool = True
    fast_featurization: bool = True
    folded_featnet: bool = False

    # precision
    mvs_dtype: str = "float32"        # compute dtype for the MVS cascade
    nerf_dtype: str = "bfloat16"      # NeRF MLP matmul dtype (params f32)
    use_pallas: bool = False          # JAX package only; the port always
                                      # runs the hand-written MLP kernel on
                                      # the card

    # observability
    profile_dir: Optional[str] = None
    debug_nans: bool = False

    # ------------------------------------------------------------------ derived
    @property
    def feat_dim(self) -> int:
        """Point-feature channel count: 24 cost-volume ch + (V-1)*(4
        color+mask + 8 img-feat) + 1 confidence."""
        return 24 + (self.view_num - 1) * (4 + 8) + 1

    @property
    def n_patch_rays(self) -> int:
        return self.patch_num * self.patch_size * self.patch_size

    @property
    def n_uniform_rays(self) -> int:
        return self.batch_size - self.n_patch_rays

    @property
    def n_train_rays(self) -> int:
        return self.batch_size + self.n_depth_rays

    @property
    def n_built_rays(self) -> int:
        """The rays a train batch holds and the step renders: ``patch_num
        // 2`` patches of each half, the uniform and the sparse-depth rays.
        At an odd ``patch_num`` that is one patch fewer than
        ``n_train_rays`` counts (the loss still slices ``n_patch_rays`` and
        ``batch_size`` rows, as the JAX package's does)."""
        return (2 * (self.patch_num // 2) * self.patch_size ** 2
                + self.n_uniform_rays + self.n_depth_rays)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


PRESETS = {
    "train_scared": dict(dataset_name="scared", view_num=7, lrate=2e-4,
                         num_epochs=30, patch_size=6, patch_num=50),
    "train_hamlyn": dict(dataset_name="hamlyn", view_num=7, lrate=2e-4,
                         num_epochs=30, patch_size=4, patch_num=50),
    "eval_scared": dict(dataset_name="scared", view_num=7, eval=True),
    "eval_hamlyn": dict(dataset_name="hamlyn", view_num=7, eval=True),
}


def _add_args(parser: argparse.ArgumentParser) -> None:
    # default=SUPPRESS so only flags the user actually typed land in the
    # namespace — an explicit flag equal to the dataclass default must still
    # override a preset.
    for f in dataclasses.fields(Config):
        name = "--" + f.name
        default = f.default
        if f.type == "bool" or isinstance(default, bool):
            parser.add_argument(name, action="store_true",
                                default=argparse.SUPPRESS)
        elif isinstance(default, tuple):
            parser.add_argument(name, nargs="+",
                                type=type(default[0]) if default else int,
                                default=argparse.SUPPRESS)
        elif default is None:
            parser.add_argument(name, type=str, default=argparse.SUPPRESS)
        else:
            parser.add_argument(name, type=type(default),
                                default=argparse.SUPPRESS)


def parse_config(argv=None) -> Config:
    """CLI -> Config.  Supports ``--preset`` and ``--config <json>``."""
    parser = argparse.ArgumentParser("ucnerf_torch")
    parser.add_argument("--preset", type=str, default=None,
                        choices=sorted(PRESETS.keys()))
    parser.add_argument("--config", type=str, default=None,
                        help="JSON file with config overrides")
    _add_args(parser)
    ns = parser.parse_args(argv)

    overrides = {}
    if ns.config:
        with open(ns.config) as fh:
            overrides.update(json.load(fh))
    if ns.preset:
        overrides.update(PRESETS[ns.preset])

    cli = {k: (tuple(v) if isinstance(v, list) else v)
           for k, v in vars(ns).items() if k not in ("preset", "config")}
    overrides.update(cli)  # explicit CLI wins over preset/json
    return Config(**overrides)
