"""Per-scene finetune dataset with an explicit index.ini train/test split
(the port of ``ucnerf_tpu.data.finetune``): a SCARED-layout scene whose
split comes from the ini file instead of the stride-2 rule.

index.ini format (configparser):
    [index]
    train = 0,2,4,...
    test  = 1,3,5,...
"""

from __future__ import annotations

import configparser
import os

import numpy as np

from ucnerf_torch.data.llff import get_nearest_pose_ids
from ucnerf_torch.data.scared import ScaredDataset


class FinetuneDataset(ScaredDataset):

    def _read_index(self, scan):
        path = os.path.join(self._scene_dir(scan), "index.ini")
        cp = configparser.ConfigParser()
        cp.read(path)
        train = np.array([int(x) for x in cp["index"]["train"].split(",")])
        test = np.array([int(x) for x in cp["index"]["test"].split(",")])
        return train, test

    def _build_metas(self, max_train_samples, sample_rate):
        self.metas = []
        for scan in self.scans:
            sc = self.scene[scan]
            train_idx, test_idx = self._read_index(scan)
            sc["train_index"], sc["test_index"] = train_idx, test_idx
            if self.split == "train":
                for _ in range(max_train_samples):
                    sel = self.rng.permutation(train_idx)
                    self.metas.append((scan, int(sel[0]),
                                       sel[1:self.nviews].tolist()))
            else:
                for ref in test_idx:
                    near = get_nearest_pose_ids(sc["c2ws"][int(ref)],
                                                sc["c2ws"][train_idx],
                                                self.nviews - 1)
                    self.metas.append((scan, int(ref),
                                       train_idx[near].tolist()))
