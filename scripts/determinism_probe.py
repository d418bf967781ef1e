"""Which parts of one train step are not run-to-run deterministic on a
CUDA card's default kernels, at ``chip_smoke.py``'s train point (320x256,
V=7, 2000 + 1024 rays, 90 samples, cascade 48/32/8, bf16 MLP) on its
bench scene, with the seeded weights.

    python3 scripts/determinism_probe.py

One forward + backward of ``train.loop.scene_loss`` on one train sample
and one set of ray draws, run twice on default kernels and twice under
``utils/platform.py::deterministic_kernels``.  Prints one JSON line: the
gradient tensors that differ between the two default runs (and, as a
control, between the two deterministic ones), the ops that warn under
``use_deterministic_algorithms(True, warn_only=True)`` (those with no
deterministic kernel at all), and how many device kernels run only on
default or only on deterministic kernels (the ops that switch), each
kernel with its launches listed in ``chiprun_out/determinism/kernels.txt``.
Exits non-zero if gradients differ on deterministic kernels.  Needs one
card; it is not part of ``chip_smoke.py``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "chiprun_out" / "determinism"


def kernel_counts(fn) -> dict:
    """{device kernel name: launches} over one call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)}


def probe(cfg, dev, batch, draws) -> dict:
    import torch
    from ucnerf_torch.models.factory import create_models, init_params
    from ucnerf_torch.train.loop import scene_loss
    from ucnerf_torch.utils.platform import deterministic_kernels

    params = init_params(cfg, torch.Generator().manual_seed(cfg.seed), dev)

    def grads():
        nerf, mvs = create_models(cfg, dev, params)
        scene_loss(cfg, nerf, mvs, batch, draws)[0].backward()
        return {n: p.grad for m in (nerf, mvs)
                for n, p in m.named_parameters() if p.grad is not None}

    def differ(a, b):
        return sorted(n for n in a if not torch.equal(a[n], b[n]))

    default = differ(grads(), grads())
    with deterministic_kernels():
        det_differ = differ(grads(), grads())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            grads()
        finally:
            torch.use_deterministic_algorithms(False)
    no_kernel = sorted({str(w.message).split(" does not have")[0]
                        for w in caught
                        if "does not have a deterministic" in str(w.message)})
    k_default = kernel_counts(grads)
    with deterministic_kernels():
        k_det = kernel_counts(grads)
    only_default = sorted(set(k_default) - set(k_det))
    only_det = sorted(set(k_det) - set(k_default))
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "kernels.txt").write_text(
        "only on default kernels:\n"
        + "".join(f"{k_default[k]:6d}x  {k}\n" for k in only_default)
        + "only on deterministic kernels:\n"
        + "".join(f"{k_det[k]:6d}x  {k}\n" for k in only_det))
    return dict(grad_tensors=len(grads()), default_differ=default,
                deterministic_differ=det_differ,
                ops_without_deterministic_kernel=no_kernel,
                n_kernels_only_default=len(only_default),
                n_kernels_only_deterministic=len(only_det))


def main():
    # cuBLAS is deterministic only with a fixed workspace: set before the
    # first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("determinism_probe: no CUDA device")
    from chip_smoke import TRAIN_ARGS, bench_scene
    from ucnerf_torch.config import parse_config
    from ucnerf_torch.data import build_dataset
    from ucnerf_torch.ops.rays import draw_train_randomness
    from ucnerf_torch.render.serving import to_device_batch

    dev = torch.device("cuda", 0)
    cfg = parse_config(TRAIN_ARGS)
    W, H = cfg.img_wh
    with bench_scene():
        batch = to_device_batch(build_dataset(cfg, "train")[0], dev)
    draws = draw_train_randomness(
        torch.Generator(device=dev).manual_seed(1), H=H, W=W,
        patch_size=cfg.patch_size, patch_num=cfg.patch_num,
        n_uniform=cfg.n_uniform_rays, n_rays=cfg.n_train_rays,
        n_samples=cfg.N_samples)
    res = probe(cfg, dev, batch, draws)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"device": smi, **res}))
    if res["deterministic_differ"]:
        raise SystemExit("determinism_probe: gradients differ on "
                         "deterministic kernels")


if __name__ == "__main__":
    main()
