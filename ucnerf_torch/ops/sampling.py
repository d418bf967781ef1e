"""Depth-candidate sampling along rays.

Per ray and cascade stage k, ``N_samples // 3`` uniformly spaced depths in
that stage's per-pixel [near_k, far_k]; concatenated, sorted, and
optionally jittered within the sorted intervals.  The jitter takes its
uniform draws as a tensor, so a test can feed both packages the same
numbers.
"""

from __future__ import annotations

import torch


def sample_points_uniform(near, far, num_samples: int):
    """near/far [..., 1] -> [..., num_samples] linearly spaced depths."""
    t = torch.linspace(0.0, 1.0, num_samples, dtype=near.dtype,
                       device=near.device)
    return near * (1.0 - t) + far * t


def stratified_jitter(depth_sorted, u):
    """Jitter sorted depths within their midpoint intervals; ``u`` holds
    uniform [0, 1) draws of ``depth_sorted``'s shape."""
    mids = 0.5 * (depth_sorted[..., 1:] + depth_sorted[..., :-1])
    upper = torch.cat([mids, depth_sorted[..., -1:]], dim=-1)
    lower = torch.cat([depth_sorted[..., :1], mids], dim=-1)
    return lower + (upper - lower) * u


def stage_depth_candidates(stage_near_far, n_samples: int, jitter_u=None):
    """stage_near_far: dict with 'near_k'/'far_k' [N_rays, 1], k in 1..3.
    Returns [N_rays, 3 * (n_samples // 3)] sorted depths, jittered with
    ``jitter_u`` when it is given."""
    avg = n_samples // 3
    per_stage = [sample_points_uniform(stage_near_far[f"near_{k}"],
                                       stage_near_far[f"far_{k}"], avg)
                 for k in (1, 2, 3)]
    depth = torch.sort(torch.cat(per_stage, dim=-1), dim=-1).values
    if jitter_u is not None:
        depth = stratified_jitter(depth, jitter_u)
    return depth
