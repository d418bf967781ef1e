"""Shared pieces of the benchmark's tests: the checkout root on the path,
a tiny size of each cell for runs on the CPU, and the card fixture."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a size every cell's drivers and reference run at on the CPU in seconds;
# the widths (MLP, cascade channels, views, samples per stage) stay
TINY_MODEL = dict(img_wh=[64, 32], ndepths=[8, 8, 8], N_samples=9,
                  batch_size=80, patch_size=4, patch_num=4, n_depth_rays=32,
                  samples_per_scene=20)
TINY_TRAFFIC = dict(chunk=512, warm_frames=1, traced_units=2)


def tiny(res, **model):
    """A resolved cell (``harness.cells.resolve``) cut to ``TINY_MODEL``,
    with ``model`` overriding configuration fields."""
    out = {k: copy.deepcopy(v) for k, v in res.items() if k != "per_layer"}
    out["per_layer"] = res["per_layer"]
    out["config"]["model"].update(TINY_MODEL, **model)
    out["config"]["scene"]["n_sparse"] = 64
    out["traffic"].update({k: v for k, v in TINY_TRAFFIC.items()
                           if k in out["traffic"]})
    return out


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
