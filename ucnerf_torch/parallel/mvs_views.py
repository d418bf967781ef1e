"""The view-sharded cascade (``--shard_mvs_views``): the port of
``ucnerf_tpu.parallel.mvs_views``.

The cascade's per-view work splits over the source views: the FeatureNet
normalizes each view with its own statistics, and the variance cost
volume is built from three sums over views, sum(f), sum(f^2) and the
in-bounds count.  Each rank of the group runs the FeatureNet and the
plane-sweep warp on its share of the views and accumulates the three
partial sums; one all-reduce each (``collectives.all_reduce_sum``, whose
adjoint is an all-reduce) rebuilds the volume that the replicated
cascade builds, up to the order of the float sums.  The CostRegNet and
the stage head then run replicated on every rank (the cascade's own
``from_features``, given a ``ViewShard``), so their gradients are
not counted once per rank: ``average_gradients`` takes the mean.

- Views pad to a multiple of the group size with zero images whose
  ``valid`` weight is 0 in all three sums.
- Padded views reuse view 0's projection, so the warp stays finite
  (``homo_warp`` divides by the warped z).
- The stage-3 features of every view (``img_feats``, which the renderer
  reads) are gathered in view order with ``collectives.all_gather``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ucnerf_torch.parallel.collectives import all_gather, all_reduce_sum


class ViewShard:
    """One rank's share of ``n_views`` source views over ``group``: the
    hook that ``CascadeMVSNet.from_features`` takes as ``views``."""

    def __init__(self, n_views: int, group, device, dtype):
        n_dev, r = dist.get_world_size(group), dist.get_rank(group)
        self.n_views, self.group = n_views, group
        self.v_pad = -(-n_views // n_dev) * n_dev
        per = self.v_pad // n_dev
        self.lo, self.hi = r * per, (r + 1) * per
        self.valid = (torch.arange(self.lo, self.hi, device=device)
                      < n_views).to(dtype)

    def images(self, imgs_src):
        """This rank's source images, zero images past the last view."""
        V, H, W = imgs_src.shape[:3]
        if self.v_pad > V:
            imgs_src = torch.cat(
                [imgs_src, imgs_src.new_zeros((self.v_pad - V, H, W, 3))])
        return imgs_src[self.lo:self.hi]

    def projs(self, projs):
        """This rank's projections [v_local, 3, 4]; a padded view reuses
        view 0's, so its warp stays finite."""
        if self.v_pad > self.n_views:
            projs = torch.cat([projs, projs[:1].expand(
                self.v_pad - self.n_views, 3, 4)])
        return projs[self.lo:self.hi]

    def reduce(self, x):
        return all_reduce_sum(x, self.group)

    def gather(self, feats):
        """Every view's features, in view order."""
        return all_gather(feats, self.group)[:self.n_views]


def make_view_sharded_cascade(mvs, group):
    """A drop-in for ``mvs(imgs_src, affine_mats, affine_mats_inv, near,
    far, pad)`` (``CascadeMVSNet.forward``) with the per-view work split
    over the ranks of ``group``; the same outputs."""

    def apply_fn(imgs_src, affine_mats, affine_mats_inv, near, far,
                 pad: int = 0):
        views = ViewShard(imgs_src.shape[0], group, imgs_src.device,
                          imgs_src.dtype)
        return mvs.from_features(mvs.features(views.images(imgs_src)),
                                 affine_mats, affine_mats_inv, near, far,
                                 pad, views=views)

    return apply_fn
