"""The ``serve`` driver: one client in a closed loop of served frames.

Each frame goes through ``render/serving.py::ServingRenderer.render_np``
(one frame in flight, as the port's HTTP server renders under its lock)
at a new target pose, timed from pose in to arrays on the host.  After
the window, frames drawn from the seed among those the window completed
are rendered again by the reference.

The mix's parameters: ``chunk`` (rays a tile), ``poses`` (length of the
drawn trajectory), ``warm_frames``, ``checked_frames``, ``traced_units``.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from portbench.harness import inputs
from portbench.harness.cells import model_config
from portbench.harness.drivers import SetupClock, program_config
from portbench.harness.trace import span
from portbench.reference import compare, step as reference

SPANS = ("frame_batch", "render", "to_host")


class Driver:
    spans = SPANS
    unit_name = "frame"

    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        from ucnerf_torch.kernels.fused_mlp import render_mlp
        from ucnerf_torch.models.factory import create_models
        from ucnerf_torch.render.serving import ServingRenderer

        clock = SetupClock(device)
        self.rc = model_config(config)
        self.chunk = traffic["chunk"]
        self.pcfg = program_config(config, chunk=self.chunk)
        self.seed, self.device = seed, torch.device(device)
        self.traced_units = traffic["traced_units"]
        self.n_checked = traffic["checked_frames"]
        W, H = self.rc.img_wh
        sc = config["scene"]
        self.scene = inputs.make_scene(seed, (W, H), sc["n_images"],
                                       sc["n_sparse"])
        ref, srcs = inputs.serve_views(self.scene, self.rc.view_num)
        self.sample = inputs.make_sample(self.scene, ref, srcs,
                                         self.rc.n_depth_rays, 0, 0, 0)
        clock("scene")
        laws = inputs.weight_laws(reference.build_models(self.rc, None,
                                                         "cpu"))
        self.weights = inputs.make_weights(laws, seed, self.device)
        clock("weights")
        nerf, mvs = create_models(self.pcfg, self.device, self.weights)
        self.renderer = ServingRenderer(self.pcfg, render_mlp(nerf), mvs,
                                        self.sample, (H, W),
                                        self.scene["intrinsic"], self.device)
        for name in ("frame_batch", "render"):
            setattr(self.renderer, name,
                    _spanned(name, getattr(self.renderer, name)))
        clock("program")
        self.poses = inputs.trajectory(seed, self.scene["c2ws"],
                                       traffic["poses"])
        self.frames = []
        for _ in range(traffic["warm_frames"]):
            self.unit()
        clock("warm_frames")
        self.setup_phases = clock.phases
        self.frames = []
        self.window_units = 0       # frames of the window, set by run.py

    def unit(self):
        c2w = self.poses[len(self.frames) % len(self.poses)]
        t0 = time.perf_counter()
        with span("to_host"):
            out = self.renderer.render_np(c2w)
        ms = (time.perf_counter() - t0) * 1e3
        self.frames.append((c2w, out, ms))
        return 1, all(np.isfinite(a).all() for a in out)

    def totals(self, done: int, seconds: float) -> Dict:
        ms = [m for _, _, m in self.frames[:self.window_units]]
        return {"serve_frames_per_s": done / seconds,
                "serve_frame_ms_p95": float(np.percentile(ms, 95))}

    def check(self) -> Dict:
        """Free the program's state, render frames drawn from the seed
        among the window's with the reference and compare."""
        del self.renderer
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        frames = self.frames[:self.window_units]
        rng = np.random.default_rng(inputs.seed_int(self.seed, 7))
        pick = rng.choice(len(frames), min(self.n_checked, len(frames)),
                          replace=False)
        self.checked_poses = [frames[i][0] for i in pick]
        self.want = self.reference_frames(self.checked_poses)
        self.got = [frames[i][1] for i in pick]
        return compare.frame_numbers(self.got, self.want)

    def control(self, precision) -> Dict:
        """After ``check``: the checked frames by the reference computed
        at ``precision`` in the program's place, compared as the
        program's are."""
        return compare.frame_numbers(
            self.reference_frames(self.checked_poses, precision), self.want)

    def frame_sample(self, c2w) -> Dict:
        """The served sample with view 0 at the pose ``c2w``."""
        s = dict(self.sample)
        c2w = np.asarray(c2w, np.float32)
        w2c = np.linalg.inv(c2w).astype(np.float32)
        aff, aff_inv = inputs.build_affine_mats(self.scene["intrinsic"], w2c)
        for key, row in (("c2ws", c2w), ("w2cs", w2c), ("affine_mat", aff),
                         ("affine_mat_inv", aff_inv)):
            arr = np.array(s[key])
            arr[0] = row
            s[key] = arr
        return s

    def reference_frames(self, poses, precision=None):
        """The frames at ``poses`` by the reference at ``precision`` (by
        default the configuration's, ``reference.stated_precision``)."""
        if precision is None:
            precision = reference.stated_precision(self.rc)
        with reference.flags(precision):
            nerf, mvs = reference.build_models(self.rc, self.weights,
                                               self.device, precision)
            out = []
            for c2w in poses:
                batch = inputs.to_device(self.frame_sample(c2w), self.device)
                out.append(tuple(t.cpu().numpy() for t in
                                 reference.render_frame(self.rc, nerf, mvs,
                                                        batch, self.chunk)))
            return out


def _spanned(name: str, fn):
    def call(*args, **kw):
        with span(name):
            return fn(*args, **kw)
    return call
