"""Device selection and deterministic kernels for the port's entry
points."""

from __future__ import annotations

import contextlib
import os

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


@contextlib.contextmanager
def deterministic_kernels(on: bool = True):
    """Deterministic kernels for the block when ``on``: sort-based
    scatter-adds, deterministic cuDNN algorithms, and cuBLAS with a fixed
    workspace (``CUBLAS_WORKSPACE_CONFIG``, which takes effect only if set
    before the process's first cuBLAS call).  With the card's default
    kernels two identical runs differ after one step: the backward's
    atomic adds change round-off, and Adam's first updates, about lr *
    sign(gradient), turn that into differences of a whole learning rate.
    The previous settings come back after the block."""
    if not on:
        yield
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0])
        torch.backends.cudnn.deterministic = prev[1]
