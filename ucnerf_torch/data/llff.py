"""Pose helpers (numpy only)."""

from __future__ import annotations

import numpy as np


def get_nearest_pose_ids(tar_pose, ref_poses, num_select):
    """Nearest views by camera-center distance."""
    dists = np.linalg.norm(tar_pose[:3, 3] - ref_poses[:, :3, 3], axis=-1)
    return np.argsort(dists)[:num_select]
