"""Model factory and the JAX package's init laws.

``init_params`` draws every weight from a ``torch.Generator`` on the CPU
(the same numbers for any device) with the laws of the JAX package:

- MLP layers: kaiming-normal weight (fan_in, relu gain) and zero bias,
  except ``pts_bias_confidence`` and ``alpha_linear_1``, which keep torch's
  default U(±1/sqrt(fan_in)) for weight and bias;
- convolutions: U(±1/sqrt(fan_in)), fan_in = in-channels x kernel volume
  for a conv and out-channels x kernel volume for a transposed conv (the
  JAX kernel's second-to-last axis), zero biases;
- BN: scale 1, shift 0;
- ``--encode_a``: the appearance table [N_vocab, N_a] drawn N(0, 1) after
  both nets, so the nets' weights do not depend on the flag.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ucnerf_torch.config import Config
from ucnerf_torch.models.layers import TorchDense
from ucnerf_torch.models.mvs import CascadeMVSNet
from ucnerf_torch.models.nerf import UCNeRFMLP


def compute_dtype(name: str) -> Optional[torch.dtype]:
    """A ``--mvs_dtype`` name -> the cascade's compute dtype (None for
    float32: no cast).  The JAX package takes any name ``jnp.dtype`` knows;
    here a name that is not a torch floating dtype raises ValueError."""
    dt = getattr(torch, name, None) if isinstance(name, str) else None
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"--mvs_dtype {name!r} is not a torch floating "
                         f"dtype (float32, bfloat16, float16, ...)")
    return None if dt == torch.float32 else dt


def _as_tensor(v):
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.array(v))


def create_models(cfg: Config, device, params: Dict = None
                  ) -> Tuple[UCNeRFMLP, CascadeMVSNet]:
    """(nerf, mvs) modules on ``device``; with ``params`` ({'nerf': state
    dict, 'mvs': state dict}, tensors or numpy arrays) loaded strictly."""
    nerf_dtype = {"float32": None, "bfloat16": torch.bfloat16}[cfg.nerf_dtype]
    nerf = UCNeRFMLP(depth=cfg.netdepth, width=cfg.netwidth,
                     multires=cfg.multires,
                     multires_views=cfg.multires_views,
                     view_num=cfg.view_num, skips=tuple(cfg.skips),
                     dtype=nerf_dtype)
    mvs = CascadeMVSNet(ndepths=tuple(cfg.ndepths),
                        depth_intervals_ratio=tuple(cfg.depth_intervals_ratio),
                        dtype=compute_dtype(cfg.mvs_dtype))
    if params is not None:
        for module, key in ((nerf, "nerf"), (mvs, "mvs")):
            module.load_state_dict(
                {k: _as_tensor(v) for k, v in params[key].items()},
                strict=True)
    return nerf.to(device), mvs.to(device)


def create_appearance(cfg: Config, device, params: Dict
                      ) -> Optional[nn.Parameter]:
    """``--encode_a``'s appearance table [N_vocab, N_a] from
    ``params['appearance']``, else None.  Adam trains it, checkpoints
    carry it, and no render reads it, as in the JAX package (and the
    reference's ``network/models.py:237-239``)."""
    if not cfg.encode_a:
        return None
    return nn.Parameter(_as_tensor(params["appearance"]).to(
        device=device, dtype=torch.float32))


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
    drawn from ``generator`` (a CPU generator), plus ``'appearance'``
    under ``--encode_a``."""
    nerf, mvs = create_models(cfg, "cpu")
    _init_module(nerf, generator)
    _init_module(mvs, generator)
    params = {name: {k: v.to(device) for k, v in m.state_dict().items()}
              for name, m in (("nerf", nerf), ("mvs", mvs))}
    if cfg.encode_a:
        params["appearance"] = torch.randn(
            (cfg.N_vocab, cfg.N_a), generator=generator).to(device)
    return params
