"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  A CUDA device without a card raises: the
    port never falls back to the CPU quietly; a caller that wants the CPU
    asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ucnerf_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' (--device cpu) to run on the CPU")
    return dev
