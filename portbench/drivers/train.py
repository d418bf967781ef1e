"""The ``train`` driver: a closed loop of full-phase training steps.

Each step goes through the port's ``train/loop.py::make_train_step``,
store-fed (``data/device_store.py``) with the host's index payloads built
one sample ahead on a thread (``utils/prefetch.py``), one scene sample a
step in the trainer's epoch order, the step's metrics read to the host
every step.  Set-up drives the first ``checked_steps`` steps through the
same calls; after the window the reference follows them.

The mix's parameters: ``checked_steps``, ``traced_units``.
"""

from __future__ import annotations

import contextlib
import itertools
import math
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import inputs
from portbench.harness.cells import model_config
from portbench.harness.drivers import SetupClock, program_config
from portbench.harness.trace import span
from portbench.reference import compare, step as reference

SPANS = ("fetch", "draws", "train_step", "read_metrics")


def _leaf_names(nerf, mvs) -> Dict[int, str]:
    return {id(p): f"{g}.{n}" for g, m in (("nerf", nerf), ("mvs", mvs))
            for n, p in m.named_parameters()}


class Driver:
    spans = SPANS
    unit_name = "step"

    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        from ucnerf_torch.data.base import SceneDataset
        from ucnerf_torch.data.device_store import build_store
        from ucnerf_torch.models.factory import create_models
        from ucnerf_torch.train.loop import (TrainState, make_lr_schedule,
                                             make_optimizer, make_train_step)

        clock = SetupClock(device)
        self.rc = model_config(config)
        self.pcfg = program_config(config)
        self.seed, self.device = seed, torch.device(device)
        self.n_checked = traffic["checked_steps"]
        self.traced_units = traffic["traced_units"]
        W, H = self.rc.img_wh
        sc = config["scene"]
        self.scene = inputs.make_scene(seed, (W, H), sc["n_images"],
                                       sc["n_sparse"])
        self.ds_seed = inputs.seed_int(seed, 5)
        scene = self.scene

        class BenchScene(SceneDataset):
            def _discover_scans(self):
                return ["bench"]

            def _load_scene(self, scan):
                return scene

        self.ds = BenchScene("", "train", self.rc.view_num, (W, H),
                             n_depth_rays=self.rc.n_depth_rays,
                             max_train_samples=self.rc.samples_per_scene,
                             seed=self.ds_seed)
        clock("scene")
        laws = inputs.weight_laws(reference.build_models(self.rc, None,
                                                         "cpu"))
        self.weights = inputs.make_weights(laws, seed, self.device)
        clock("weights")
        nerf, mvs = create_models(self.pcfg, self.device, self.weights)
        self.state = TrainState(nerf, mvs,
                                make_optimizer(self.pcfg, nerf, mvs),
                                objective="full")
        self.names = _leaf_names(nerf, mvs)
        self.train_step = make_train_step(
            self.pcfg, make_lr_schedule(self.pcfg, len(self.ds)))
        clock("program")
        self.store = build_store(self.ds, self.device)
        clock("store")
        self.draw_shape = dict(H=H, W=W, patch_size=self.rc.patch_size,
                               patch_num=self.rc.patch_num,
                               n_uniform=self.rc.n_uniform_rays,
                               n_rays=self.rc.n_train_rays,
                               n_samples=self.rc.N_samples)
        self.stream = self._samples()
        self.checked = dict(samples=[], draws=[], loss=[], terms=[],
                            pixels=[], confidence=[])
        with _recording_rays(self.checked["pixels"],
                             self.checked["confidence"]):
            for _ in range(self.n_checked):
                self.unit()
                if self.state.step == 1:
                    self.checked["grad_norm"] = self._first_grad_norms()
        self.checked["change"] = self._changes()
        clock("checked_steps")
        self.setup_phases = clock.phases

    def _samples(self):
        """(epoch, index, payload) in the trainer's order: one shuffle of
        the train samples an epoch, index payloads built on a thread."""
        from ucnerf_torch.data.device_store import sample_indices
        from ucnerf_torch.utils.prefetch import ThreadPrefetcher
        order_seed = inputs.seed_int(self.seed, 6)
        for epoch in itertools.count():
            self.ds.set_epoch(epoch)
            order = np.random.default_rng(np.random.SeedSequence(
                [order_seed, 1 + epoch])).permutation(len(self.ds))
            thunks = ((lambda i=int(i): (i, sample_indices(self.ds, i)))
                      for i in order)
            with ThreadPrefetcher(thunks, depth=2) as loader:
                for idx, payload in loader:
                    yield epoch, idx, payload

    def unit(self):
        from ucnerf_torch.data.device_store import gather_batch
        from ucnerf_torch.ops.rays import TrainDraws
        from ucnerf_torch.render.serving import to_device_batch
        step = self.state.step
        with span("fetch"):
            epoch, idx, payload = next(self.stream)
            batch = gather_batch(self.store,
                                 to_device_batch(payload, self.device))
        with span("draws"):
            draws = inputs.train_draws(self.seed, step, device=self.device,
                                       **self.draw_shape)
        with span("train_step"):
            metrics = self.train_step(self.state, batch,
                                      TrainDraws(**vars(draws)))
        with span("read_metrics"):
            values = {k: float(v) for k, v in metrics.items()}
        if step < self.n_checked:
            self.checked["samples"].append((epoch, idx))
            self.checked["draws"].append(draws)
            self.checked["loss"].append(values["loss"])
            self.checked["terms"].append(values)
        return self.rc.n_train_rays, math.isfinite(values["loss"])

    def _first_grad_norms(self) -> Dict[str, float]:
        """Each leaf's first gradient as Adam got it: its first moment
        after one step over (1 - beta1); 0 for a leaf Adam holds no
        moment of."""
        opt = self.state.optimizer
        out = {}
        for group in opt.param_groups:
            b1 = group["betas"][0]
            for p in group["params"]:
                m = opt.state.get(p, {}).get("exp_avg")
                out[self.names[id(p)]] = (0.0 if m is None else float(
                    torch.linalg.vector_norm(m.double()) / (1.0 - b1)))
        return out

    def _changes(self) -> Dict[str, torch.Tensor]:
        """Each leaf's change over the checked steps."""
        return {f"{g}.{n}": (p.detach() - self.weights[g][n]).clone()
                for g, m in (("nerf", self.state.nerf), ("mvs", self.state.mvs))
                for n, p in m.named_parameters()}

    def totals(self, done: int, seconds: float) -> Dict:
        return {"train_rays_per_s": done / seconds}

    def close(self):
        self.stream.close()

    def check(self) -> Dict:
        """Free the program's state, follow the checked steps with the
        reference and compare (``compare.train_numbers``)."""
        self.close()
        del self.state, self.store, self.train_step
        got = dict(loss=self.checked["loss"], terms=self.checked["terms"],
                   confidence1=self.checked["confidence"][0],
                   grad_norm=self.checked["grad_norm"],
                   change=self.checked["change"],
                   change_norm=reference.leaf_norms(self.checked["change"]))
        self.got = got
        return compare.train_numbers(
            got, self.reference_steps(pixels=self.checked["pixels"]))

    def control(self, precision) -> Dict:
        """After ``check``: the reference computed at ``precision`` in the
        program's place, compared as the program is."""
        got = self.reference_steps(precision)
        return compare.train_numbers(
            got, self.reference_steps(pixels=got["pixels"]))

    def reference_steps(self, precision=None, pixels=None) -> Dict:
        """The checked steps by the reference at ``precision`` (by default
        the configuration's, ``reference.stated_precision``), through
        ``pixels`` when given."""
        if precision is None:
            precision = reference.stated_precision(self.rc)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        metas = inputs.train_metas(self.scene, self.rc.view_num,
                                   self.rc.samples_per_scene, self.ds_seed)
        batches = []
        for epoch, idx in self.checked["samples"]:
            ref, srcs = metas[idx]
            batches.append(inputs.to_device(inputs.make_sample(
                self.scene, ref, srcs, self.rc.n_depth_rays, self.ds_seed,
                epoch, idx), self.device))
        lrs = [reference.cosine_lr(self.rc, s, self.rc.samples_per_scene)
               for s in range(len(batches))]
        with reference.flags(precision):
            nerf, mvs = reference.build_models(self.rc, self.weights,
                                               self.device, precision)
            return reference.train_steps(self.rc, nerf, mvs, batches,
                                         self.checked["draws"], lrs, pixels)


@contextlib.contextmanager
def _recording_rays(pixels: List, confidences: List):
    """Keep the pixels (ys, xs) of every train-ray batch the program's
    train step builds inside the block, and the cascade's confidence they
    were drawn from.  The patch pixels are drawn from that confidence,
    where TF32's round-off can flip a near tie; the reference follows the
    program's rays, checks the first step's draw apart (``draw1_gap``)
    and compares the confidence itself (``conf1_p90``)."""
    from ucnerf_torch.train import loop
    build = loop.build_train_rays

    def recorded(*args, **kw):
        rays = build(*args, **kw)
        coords = rays["pixel_coords"].detach()
        pixels.append((coords[:, 0].clone(), coords[:, 1].clone()))
        confidences.append(kw["confidence"].detach().clone())
        return rays
    loop.build_train_rays = recorded
    try:
        yield
    finally:
        loop.build_train_rays = build
