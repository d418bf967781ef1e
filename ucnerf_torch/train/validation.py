"""Validation over the whole val split: the port of ``train.py:44-289``.

``Validator`` is built once per run.  It holds the val dataset and, with
``--device_dataset``, the val scenes' store on the device (a view's batch
is then gathered there from an index payload; the GT arrays for the
metrics come from the dataset's scene arrays).  Each call renders every
val view with the eval render on the fused MLP kernel, packed anew from
the current weights (``render_mlp``: on the CPU the plain MLP where the
kernel does not take its shape; on the card such a shape raises), groups the views per scan, and writes to
``<basedir>/<expname>/test_results/``:

- ``rgb_evaluation.txt``: PSNR, SSIM, LPIPS and, where GT depth exists,
  the 7 depth metrics, each the mean over scans, plus ``per_scan`` with
  more than one scan (the JAX package's keys);
- ``mvs_evaluation.txt`` under ``--mvs_only``: the cascade's stage-3 depth
  against GT depth, the 7 depth metrics over the split;
- ``{step:08d}_{i:02d}.png`` per val view with ``--val_panels all``, or
  at the run's last validation with ``final`` (the default): the 2x2
  GT/rendered RGB and depth panel of ``utils/viz.py``.
"""

from __future__ import annotations

import json
import os
import queue
import sys
import threading
import time
from typing import Dict

import numpy as np
import torch

from ucnerf_torch.data import build_dataset
from ucnerf_torch.data.base import unnormalize_image
from ucnerf_torch.data.device_store import (build_store, gather_batch,
                                            sample_indices)
from ucnerf_torch.eval.lpips import load_lpips
from ucnerf_torch.eval.metrics import (DEPTH_METRICS, depth_evaluation,
                                       rgb_evaluation)
from ucnerf_torch.kernels.fused_mlp import render_mlp
from ucnerf_torch.render.serving import to_device_batch
from ucnerf_torch.train.loop import make_eval_render, run_mvs
from ucnerf_torch.utils.viz import save_val_panel

LPIPS_WARNING = (
    "WARNING: LPIPS weights not found (pretrained_weights/lpips_alex.npz "
    "or $UCNERF_LPIPS_WEIGHTS): the LPIPS column of the evaluation reads "
    "nan, which is not a bug.  Convert them once with\n"
    "  python convert_weights.py lpips <lpips_alex_state.pth> "
    "pretrained_weights/lpips_alex.npz\n"
    "(save the state on any machine with the lpips package: "
    "torch.save(lpips.LPIPS(net='alex').state_dict(), 'lpips_alex.pth'))")


class Validator:
    """The val split, its device store and the lazily loaded LPIPS, built
    once per run; ``validator(nerf, mvs)`` -> metrics dict.  With a
    ``mesh`` of more than one rank every rank renders its share of each
    view's tiles (``train/loop.py::make_eval_render`` on the mesh) and
    rank 0 alone computes the metrics and writes the files; the others
    return ``{}``."""

    def __init__(self, cfg, device, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = torch.device(device)
        self.val_ds = build_dataset(cfg, "val")
        self.store = (build_store(self.val_ds, self.device)
                      if cfg.device_dataset else None)
        self._lpips_fn = None
        self._lpips_tried = False
        self.panels = None      # the last validation's panel count and time

    @property
    def out_dir(self) -> str:
        return os.path.join(self.cfg.basedir, self.cfg.expname,
                            "test_results")

    @property
    def lpips_fn(self):
        if not self._lpips_tried:
            self._lpips_tried = True
            self._lpips_fn = load_lpips(device=self.device)
            if self._lpips_fn is None:
                print(LPIPS_WARNING, file=sys.stderr)
        return self._lpips_fn

    def val_batch(self, i: int):
        """(device batch, host GT {image, depth, scan_idx}) of val view
        ``i``."""
        ds = self.val_ds
        if self.store is None:
            sample = ds[i]
            gt = dict(image=sample["images"][0], depth=sample["depths_h"],
                      scan_idx=int(sample["scan_idx"]))
            return to_device_batch(sample, self.device), gt
        scan, ref, _ = ds.metas[i]
        sc = ds.scene[scan]
        W, H = ds.img_wh
        gt = dict(image=np.asarray(sc["images"][ref], np.float32),
                  depth=(np.asarray(sc["depths"][ref], np.float32)
                         if sc.get("depths") is not None
                         else np.zeros((H, W), np.float32)),
                  scan_idx=ds.scans.index(scan))
        inds = to_device_batch(sample_indices(ds, i), self.device)
        return gather_batch(self.store, inds), gt

    def __call__(self, nerf, mvs, step: int = 0, final: bool = True
                 ) -> Dict:
        """Metrics of one validation at ``step``; ``final`` marks the
        run's last one (``--val_panels final`` writes panels there only)."""
        if self.cfg.mvs_only:
            return run_mvs_validation(self, mvs)
        panels = (self.cfg.val_panels == "all"
                  or (self.cfg.val_panels == "final" and final))
        return run_validation(self, nerf, mvs, step if panels else None)


class PanelWriter:
    """Writes validation panels on a worker thread, so the PNG encoding
    overlaps the metrics.  Leaving the ``with`` block joins the thread
    and re-raises the first error a panel met.  ``written`` counts the
    panels, ``seconds`` the worker's time on them."""

    def __init__(self):
        self._jobs = queue.Queue()
        self._errors = []
        self.written = 0
        self.seconds = 0.0
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        while (job := self._jobs.get()) is not None:
            t0 = time.perf_counter()
            try:
                save_val_panel(*job)
                self.written += 1
            except Exception as e:      # re-raised by __exit__
                self._errors.append(e)
            self.seconds += time.perf_counter() - t0

    def put(self, path: str, gt_rgb, pred_rgb, gt_depth, pred_depth):
        self._jobs.put((path, gt_rgb, pred_rgb, gt_depth, pred_depth))

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self._jobs.put(None)
        self._thread.join()
        if exc_type is None and self._errors:
            raise self._errors[0]


def _write(path: str, metrics: Dict):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(json.dumps(metrics, indent=1))


def run_mvs_validation(validator: Validator, mvs) -> Dict:
    """``--mvs_only`` validation: the cascade's stage-3 depth against GT
    depth over the val split (the depth half of the reference's
    validation_step, ``train.py:238-243`` + ``utils/evaluation.py:29-74``);
    ``{}`` when the split has no GT depth."""
    cfg = validator.cfg
    if validator.mesh is not None and not validator.mesh.is_main:
        return {}
    gts, preds = [], []
    with torch.no_grad():
        for i in range(len(validator.val_ds)):
            batch, gt = validator.val_batch(i)
            gts.append(gt["depth"])
            preds.append(run_mvs(cfg, mvs, batch)["stage3"]["depth"])
    gt_depths = np.stack(gts)
    masks = (gt_depths > 0).astype(np.float32)
    metrics = {}
    if masks.any():
        pred = np.stack([p.cpu().numpy() for p in preds])
        metrics = dict(zip(DEPTH_METRICS, depth_evaluation(
            gt_depths, pred, masks).tolist()))
    _write(os.path.join(validator.out_dir, "mvs_evaluation.txt"), metrics)
    return metrics


def run_validation(validator: Validator, nerf, mvs, panel_step=None
                   ) -> Dict:
    """Every val view rendered on the fused MLP, the metrics per scan, and
    their means over scans (the reference's on_validation_epoch_end groups
    val views per scan, ``train.py:342-379``).  With ``panel_step`` each
    view's GT/rendered panel goes to
    ``test_results/{panel_step:08d}_{i:02d}.png``."""
    cfg, ds, mesh = validator.cfg, validator.val_ds, validator.mesh
    W, H = ds.img_wh
    render_view = make_eval_render(cfg, render_mlp(nerf), mvs, (H, W),
                                   mesh=mesh)
    gts, rgbs, depths = [], [], []
    for i in range(len(ds)):
        batch, gt = validator.val_batch(i)
        rgb, depth, _ = render_view(batch)
        gts.append(gt)
        rgbs.append(rgb)
        depths.append(depth)
    validator.panels = None
    if mesh is not None and not mesh.is_main:
        return {}
    if panel_step is None:
        return rgb_metrics(validator, gts, rgbs, depths)
    with PanelWriter() as panels:
        for i, gt in enumerate(gts):
            panels.put(os.path.join(validator.out_dir,
                                    f"{panel_step:08d}_{i:02d}.png"),
                       np.clip(unnormalize_image(gt["image"]), 0, 1),
                       rgbs[i].cpu().numpy(), gt["depth"],
                       depths[i].cpu().numpy())
        metrics = rgb_metrics(validator, gts, rgbs, depths)
    validator.panels = dict(panels=panels.written,
                            panel_ms_per_view=panels.seconds * 1e3
                            / max(panels.written, 1))
    return metrics


def rgb_metrics(validator: Validator, gts, rgbs, depths) -> Dict:
    """PSNR, SSIM, LPIPS and the depth metrics per scan and their means
    over scans, written to ``rgb_evaluation.txt``."""
    ds, dev = validator.val_ds, validator.device
    lpips_fn = validator.lpips_fn
    scans = np.asarray([g["scan_idx"] for g in gts])
    rgb_rows, depth_rows, per_scan = [], [], {}
    for s in sorted(set(scans.tolist())):
        sel = np.flatnonzero(scans == s)
        gt_rgb = torch.as_tensor(np.stack(
            [np.clip(unnormalize_image(gts[j]["image"]), 0, 1) for j in sel]),
            device=dev)
        psnr_v, ssim_v, lpips_v = rgb_evaluation(
            gt_rgb, torch.stack([rgbs[j] for j in sel]), lpips_fn=lpips_fn)
        rgb_rows.append([psnr_v, ssim_v, lpips_v])
        row = dict(psnr=psnr_v, ssim=ssim_v, lpips=lpips_v)
        gt_d = np.stack([gts[j]["depth"] for j in sel])
        if (gt_d > 0).any():
            derr = depth_evaluation(
                gt_d, np.stack([depths[j].cpu().numpy() for j in sel]),
                (gt_d > 0).astype(np.float32))
            depth_rows.append(derr)
            row.update(zip(DEPTH_METRICS, derr.tolist()))
        per_scan[ds.scans[s]] = row
    psnr_v, ssim_v, lpips_v = np.stack(rgb_rows).mean(axis=0).tolist()
    metrics = dict(psnr=psnr_v, ssim=ssim_v, lpips=lpips_v)
    if depth_rows:
        metrics.update(zip(DEPTH_METRICS,
                           np.stack(depth_rows).mean(axis=0).tolist()))
    if len(per_scan) > 1:
        metrics["per_scan"] = per_scan
    _write(os.path.join(validator.out_dir, "rgb_evaluation.txt"), metrics)
    return metrics
