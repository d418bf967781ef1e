"""Model factory and the JAX package's init laws.

``init_params`` draws every weight from a ``torch.Generator`` on the CPU
(the same numbers for any device) with the laws of the JAX package:

- MLP layers: kaiming-normal weight (fan_in, relu gain) and zero bias,
  except ``pts_bias_confidence`` and ``alpha_linear_1``, which keep torch's
  default U(±1/sqrt(fan_in)) for weight and bias;
- convolutions: U(±1/sqrt(fan_in)), fan_in = in-channels x kernel volume
  for a conv and out-channels x kernel volume for a transposed conv (the
  JAX kernel's second-to-last axis), zero biases;
- BN: scale 1, shift 0.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from ucnerf_torch.config import Config
from ucnerf_torch.models.layers import TorchDense
from ucnerf_torch.models.mvs import CascadeMVSNet
from ucnerf_torch.models.nerf import UCNeRFMLP


def create_models(cfg: Config, device, params: Dict = None
                  ) -> Tuple[UCNeRFMLP, CascadeMVSNet]:
    """(nerf, mvs) modules on ``device``; with ``params`` ({'nerf': state
    dict, 'mvs': state dict}, tensors or numpy arrays) loaded strictly."""
    if cfg.mvs_dtype != "float32":
        raise NotImplementedError(
            "ucnerf_torch runs the cascade in float32 only (mvs_dtype)")
    if not cfg.fast_featurization:
        raise NotImplementedError(
            "ucnerf_torch renders with the fast featurization only "
            "(fast_featurization false selects the literal path, not "
            "ported)")
    nerf_dtype = {"float32": None, "bfloat16": torch.bfloat16}[cfg.nerf_dtype]
    nerf = UCNeRFMLP(depth=cfg.netdepth, width=cfg.netwidth,
                     multires=cfg.multires,
                     multires_views=cfg.multires_views,
                     view_num=cfg.view_num, skips=tuple(cfg.skips),
                     dtype=nerf_dtype)
    mvs = CascadeMVSNet(ndepths=tuple(cfg.ndepths),
                        depth_intervals_ratio=tuple(cfg.depth_intervals_ratio))
    if params is not None:
        for module, key in ((nerf, "nerf"), (mvs, "mvs")):
            module.load_state_dict(
                {k: v if isinstance(v, torch.Tensor)
                 else torch.from_numpy(np.array(v))
                 for k, v in params[key].items()}, strict=True)
    return nerf.to(device), mvs.to(device)


def _init_module(module: nn.Module, gen: torch.Generator):
    for m in module.modules():
        if isinstance(m, TorchDense):
            fan_in = m.in_features
            if m.kaiming:
                std = math.sqrt(2.0 / fan_in)
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * std)
                m.bias.zero_()
            else:
                bound = 1.0 / math.sqrt(fan_in)
                m.weight.uniform_(-bound, bound, generator=gen)
                m.bias.uniform_(-bound, bound, generator=gen)
        elif isinstance(m, nn.modules.conv._ConvNd):
            w = m.weight
            bound = 1.0 / math.sqrt(w.shape[1] * math.prod(w.shape[2:]))
            w.uniform_(-bound, bound, generator=gen)
            if m.bias is not None:
                m.bias.zero_()


@torch.no_grad()
def init_params(cfg: Config, generator: torch.Generator, device
                ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Fresh weights {'nerf': state dict, 'mvs': state dict} on ``device``,
    drawn from ``generator`` (a CPU generator)."""
    nerf, mvs = create_models(cfg, "cpu")
    _init_module(nerf, generator)
    _init_module(mvs, generator)
    return {name: {k: v.to(device) for k, v in m.state_dict().items()}
            for name, m in (("nerf", nerf), ("mvs", mvs))}
