"""The numbers that decide ``correct``: what the timed path produced
against the plain reference (at the configuration's stated precision),
each a relative gap.  A cell's ``checks`` file names the ones compared,
each with its limit; the others are printed as notes.

Training (the first steps of the window's own state):

- ``loss1_gap``: |loss - reference loss| / |reference loss| at the first
  step, where both sides start from the same weights; ``loss_gap`` the
  largest over the checked steps;
- ``img1_gap``, ``mvs1_gap``, ...: each loss term's relative gap at the
  first step (``TERMS1``); ``mvs1_gap`` reads the cascade alone;
- ``grad_gap``: the worst leaf's gap between the program's first gradient
  norm and the reference's, over the larger of that leaf's reference norm
  and the median leaf's; ``grad_gap_median`` the median leaf's;
- ``change_gap``: the same of each leaf's change over the checked steps,
  leaving out the leaves whose reference gradient is under a thousandth of
  the median leaf's (Adam moves those by round-off alone);
  ``change_gap_median`` the median leaf's;
- ``draw1_gap``: how far the first step's train rays lie from a draw out
  of the reference's confidence (``render.draw_gap``); ``draw_gap`` the
  largest over the checked steps;
- ``conf1_p90``, ``conf1_mean``: the cascade's confidence at the first
  step, per pixel: the 90th percentile and the mean of the absolute gap.

Serving (frames sampled from the window): per pixel the absolute gap of
rgb, of confidence, and of depth over the reference's mean depth; per frame
their mean and percentiles over the pixels; the worst frame's.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import numpy as np
import torch

# a leaf whose reference gradient norm is under this share of the median
# leaf's is left out of ``change_gap``
TINY_GRAD = 1e-3


def _gap(x: float) -> float:
    """A gap that is not a finite number reads infinite, so that no
    ``max`` drops it."""
    return x if math.isfinite(x) else math.inf


def _leaf_gaps(got: Dict[str, float], want: Dict[str, float], keep):
    med = statistics.median(want[k] for k in keep)
    return {k: _gap(abs(got[k] - want[k]) / max(want[k], med, 1e-30))
            for k in keep}


# the loss terms compared at the first step, under the names of the
# numbers: the image term (MLP, featurization, compositing, the rays'
# colours), the cascade's depth term, and the rendered depth's three
TERMS1 = dict(img1_gap="img_mse", mvs1_gap="mvs", depth1_gap="nerf_depth",
              smooth1_gap="smooth", scaleinv1_gap="scaleinv")


def _rel(a: float, b: float) -> float:
    return _gap(abs(a - b) / max(abs(b), 1e-30))


def _flips(got, want, keep):
    """Per leaf in ``keep``: (share of elements whose change has the other
    sign than the reference's, element count)."""
    out = {}
    for k in keep:
        g, w = got[k].double().ravel(), want[k].double().ravel()
        out[k] = (float((torch.sign(g) != torch.sign(w)).double().mean()),
                  int(w.numel()))
    return out


def train_numbers(got: Dict, want: Dict) -> Dict:
    """``got`` / ``want``: {'loss': [..], 'terms': [{term: value}, ..],
    'confidence1': tensor, 'grad_norm': {leaf: norm}, 'change_norm':
    {leaf: norm}, 'change': {leaf: tensor}} of the program and of the
    reference (which followed
    the program's rays and measured ``patch_gap`` and ``draw_gap``).
    ``change_flip_share``: the share of the moved leaves' elements whose
    change has the other sign than the reference's."""
    loss_gap = max(_rel(a, b) for a, b in zip(got["loss"], want["loss"]))
    leaves = sorted(want["grad_norm"])
    grad = _leaf_gaps(got["grad_norm"], want["grad_norm"], leaves)
    med = statistics.median(want["grad_norm"].values())
    moved = [k for k in leaves if want["grad_norm"][k] >= TINY_GRAD * med]
    change = _leaf_gaps(got["change_norm"], want["change_norm"], moved)
    worst_grad = max(grad, key=grad.get)
    worst_change = max(change, key=change.get)
    out = dict(loss_gap=loss_gap, loss1_gap=_rel(got["loss"][0],
                                                  want["loss"][0]))
    for name, term in TERMS1.items():
        out[name] = _rel(got["terms"][0][term], want["terms"][0][term])
    out.update(
        grad_gap=grad[worst_grad], change_gap=change[worst_change],
        grad_gap_median=statistics.median(grad.values()),
        change_gap_median=statistics.median(change.values()),
        patch_gap=want.get("patch_gap", 0.0),
        patch1_gap=want.get("patch1_gap", 0.0),
        draw_gap=want.get("draw_gap", 0.0),
        draw1_gap=want.get("draw1_gap", 0.0),
        worst_grad_leaf=worst_grad, worst_change_leaf=worst_change,
        worst_changes=sorted(((k, change[k]) for k in moved),
                             key=lambda kv: -kv[1])[:5],
        leaves_left_out=sorted(set(leaves) - set(moved)))
    if "confidence1" in got and "confidence1" in want:
        gap = (got["confidence1"].double() - want["confidence1"].double()
               ).abs().cpu().numpy()
        q = _quantiles(gap)
        out["conf1_p90"], out["conf1_mean"] = q["p90"], q["mean"]
    if "change" in got and "change" in want:
        flips = _flips(got["change"], want["change"], moved)
        n = sum(c for _, c in flips.values())
        out["change_flip_share"] = sum(f * c for f, c in flips.values()) / n
        out["worst_changes"] = [(k, v, *flips[k])
                                for k, v in out["worst_changes"]]
    return out


def _quantiles(x) -> Dict[str, float]:
    x = np.asarray(x, np.float64).ravel()
    if not np.isfinite(x).all():
        return {q: math.inf for q in ("mean", "p50", "p90", "p99")}
    return dict(mean=float(x.mean()),
                **{f"p{q}": float(np.percentile(x, q)) for q in (50, 90, 99)})


def frame_numbers(got: List, want: List) -> Dict:
    """``got`` / ``want``: lists of (rgb, depth, confidence) numpy frames.
    Per frame and pixel: the rgb gap (mean over channels), the depth gap
    over the reference's mean depth, the confidence gap; for each, the
    mean over pixels and its 50th, 90th and 99th percentiles, the worst
    frame's."""
    out: Dict[str, float] = {}
    for (g_rgb, g_d, g_c), (w_rgb, w_d, w_c) in zip(got, want):
        per_px = dict(rgb=np.abs(g_rgb - w_rgb).mean(-1),
                      depth=np.abs(g_d - w_d) / np.mean(np.abs(w_d)),
                      conf=np.abs(g_c - w_c))
        for name, gap in per_px.items():
            for q, v in _quantiles(gap).items():
                key = f"{name}_{q}"
                out[key] = max(out.get(key, 0.0), _gap(v))
    return out
