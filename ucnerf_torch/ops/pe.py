"""NeRF frequency positional encoding.

Layout ``[x, sin(x*f_0)..sin(x*f_{K-1}), cos(x*f_0)..cos(x*f_{K-1})]`` with
the frequency axis major inside each sin/cos block (``scaled[..., k*d + j]
= x_j * f_k``), frequencies ``2**k`` (exact powers of two).
"""

from __future__ import annotations

import torch


def pe_dim(multires: int, input_dims: int = 3) -> int:
    return input_dims * (1 + 2 * multires)


def positional_encoding(x: torch.Tensor, multires: int) -> torch.Tensor:
    """x [..., d] -> [..., d*(1+2*multires)]."""
    if multires <= 0:
        return x
    freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
    scaled = (x[..., None, :] * freqs[:, None]).reshape(*x.shape[:-1], -1)
    return torch.cat([x, torch.sin(scaled), torch.cos(scaled)], dim=-1)
