"""Smoke test of ucnerf_torch on one CUDA card: builds the port's kernels,
holds each against its plain PyTorch version, and serves novel views at
the SCARED operating point through ``python -m ucnerf_torch.serve``'s entry
point.

    python3 chip_smoke.py

Phases (one line each): device, build, K1 vs plain, serving.  Any failed
check raises, so the script exits non-zero and prints no result.  Before
the last line it prints the card's ``nvidia-smi`` name and power limit and
one JSON line with every kernel of the serving path; the last line is
``{"ok": true, "device": {...}}``.  Frames and a JSON record go to
``chiprun_out/chip_smoke/`` beside this file.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out" / "chip_smoke"
PEAK_BF16 = 989e12          # H100 SXM dense tensor-core FLOP/s
PEAK_F32 = 67e12            # H100 SXM FP32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM HBM3 bytes/s
SERVE_ARGS = ["--dataset_name", "synthetic", "--img_wh", "320", "256",
              "--view_num", "7"]
N_REQUESTS = 3


def check(ok: bool, msg: str):
    if not ok:
        raise AssertionError(msg)


def log(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def mlp_inputs(n_rays: int, n_samples: int, feat_dim: int, seed: int, dev):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.0, 1.0, (n_rays, n_samples, 3))
    dirs = rng.standard_normal((n_rays, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    feats = rng.standard_normal((n_rays, n_samples, feat_dim))
    feats[..., -1] = rng.uniform(0.0, 1.0, (n_rays, n_samples))
    return [torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
            for a in (pts, dirs, feats)]


def mlp_work(cfg, n_rays: int, n_samples: int, weight_bytes: int):
    """(FLOPs, bytes) that one MLP call must do / move at these shapes."""
    v1 = cfg.view_num - 1
    W = cfg.netwidth
    macs = ((24 + 4 * v1) * W + 8 * v1 * W      # depth_bias, feats_bias
            + 63 * W + 4 * W * W + (63 + W) * W  # trunk (skip at layer 5)
            + W * 4                              # base rgb + alpha heads
            + W * W                              # feature_linear
            + 2 * (W + 27) * (W // 2)            # views / view_confi
            + (W // 2) * 4)                      # adapt rgb + alpha heads
    P = n_rays * n_samples
    nbytes = (P * 3 + n_rays * 3 + P * cfg.feat_dim + P * 4) * 4 + weight_bytes
    return 2 * macs * P, nbytes, macs


def profile_frame(fn, top: int = 12) -> dict:
    """Device time by kernel over one call of ``fn`` (torch.profiler), the
    device's busy share of the wall time, and the table in full under
    OUT_DIR/profile.txt."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = {e.key: (e.self_device_time_total, e.count) for e in events}
    busy_ms = sum(us for us, _ in dev_us.values()) / 1e3
    kernels = sorted(dev_us.items(), key=lambda kv: -kv[1][0])
    (OUT_DIR / "profile.txt").write_text("".join(
        f"{us / 1e3:10.3f} ms {n:6d}x  {k}\n" for k, (us, n) in kernels))
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=1.0 - busy_ms / wall_ms,
                n_device_kernels=sum(e.count for e in events),
                top_kernels_ms={k[:80]: us / 1e3
                                for k, (us, _) in kernels[:top]})


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return smi


def ptxas_by_kernel(text: str) -> dict:
    """``-Xptxas -v`` output -> {entry: {registers, stack_bytes,
    spill_stores, spill_loads, static_smem_bytes}}, entries named by the
    ``fused_mlp_*_kernel`` part of the mangled name."""
    out, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", ln)
        if m:
            k = re.search(r"(fused_mlp_[a-z0-9]+_kernel)", m.group(1))
            cur = out.setdefault(k.group(1) if k else m.group(1),
                                 {"static_smem_bytes": 0})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", ln)
        if m:
            cur["static_smem_bytes"] = int(m.group(1))
    return out


def phase_build():
    from ucnerf_torch.kernels import build
    t0 = time.perf_counter()
    res = build.build("fused_mlp")
    log("build", kernel="fused_mlp", seconds=time.perf_counter() - t0,
        nvcc_seconds=res["seconds"], ptxas=ptxas_by_kernel(res["ptxas"]))


def phase_k1(cfg, dev):
    """K1 against its plain version at the serving shape and a ragged one."""
    from ucnerf_torch.kernels.fused_mlp import (FusedNeRFMLP, fused_nerf_mlp,
                                                kernel_attrs)
    from ucnerf_torch.models.factory import create_models, init_params

    params = init_params(cfg, torch.Generator().manual_seed(0), dev)
    nerf = {dt: create_models(cfg.replace(nerf_dtype=dt), dev, params)[0]
            for dt in ("float32", "bfloat16")}
    fused = {dt: FusedNeRFMLP(m) for dt, m in nerf.items()}
    S = cfg.N_samples
    res = {}
    with torch.no_grad():
        for n_rays, key in ((cfg.chunk, "serving"), (37, "ragged")):
            pts, dirs, feats = mlp_inputs(n_rays, S, cfg.feat_dim, 1, dev)
            truth = nerf["float32"](pts, dirs, feats)
            plain_bf16 = nerf["bfloat16"](pts, dirs, feats)
            k32 = fused["float32"](pts, dirs, feats)
            k16 = fused["bfloat16"](pts, dirs, feats)
            torch.cuda.synchronize()
            err32 = (k32 - truth).abs()
            err16 = (k16 - truth).abs()
            err_plain16 = (plain_bf16 - truth).abs()
            r = dict(points=n_rays * S,
                     f32_max_abs_err=err32.max().item(),
                     f32_mean_abs_err=err32.mean().item(),
                     bf16_vs_plain_bf16_max_abs_err=(
                         k16 - plain_bf16).abs().max().item(),
                     bf16_vs_plain_bf16_mean_abs_err=(
                         k16 - plain_bf16).abs().mean().item(),
                     bf16_vs_f32_mean_abs_err=err16.mean().item(),
                     bf16_vs_f32_q99_abs_err=torch.quantile(
                         err16.flatten()[:2 ** 24], 0.99).item(),
                     plain_bf16_vs_f32_mean_abs_err=err_plain16.mean().item())
            # tolerances: f32 max abs err 1e-4; bf16 the JAX package's
            # bounds against the f32 truth, and a mean abs diff to the
            # plain bf16 version of 1e-4 (both round at the same points; a
            # rare one-ulp flip in a layer output moves single points)
            check(r["f32_max_abs_err"] <= 1e-4
                  and r["bf16_vs_plain_bf16_mean_abs_err"] <= 1e-4,
                  f"K1 disagrees with its plain version ({key}): {r}")
            check(r["bf16_vs_f32_mean_abs_err"]
                  <= 2 * r["plain_bf16_vs_f32_mean_abs_err"] + 5e-3
                  and r["bf16_vs_f32_q99_abs_err"] <= 0.25,
                  f"K1 bf16 out of bounds ({key}): {r}")
            res[key] = r
        # timing at the serving shape (one tile: chunk rays x N_samples)
        pts, dirs, feats = mlp_inputs(cfg.chunk, S, cfg.feat_dim, 1, dev)
        before = fused_nerf_mlp.launches
        times = {
            "bf16_ms": time_ms(lambda: fused["bfloat16"](pts, dirs, feats)),
            "f32_ms": time_ms(lambda: fused["float32"](pts, dirs, feats)),
            "plain_bf16_ms": time_ms(
                lambda: nerf["bfloat16"](pts, dirs, feats), iters=5),
            "plain_f32_ms": time_ms(
                lambda: nerf["float32"](pts, dirs, feats), iters=5)}
        fused_nerf_mlp.launches = before   # comparison launches do not count
    wbytes = {dt: f.packed.weights.numel() * f.packed.weights.element_size()
              + f.packed.biases.numel() * 4 for dt, f in fused.items()}
    flops, nbytes, macs = mlp_work(cfg, cfg.chunk, S, wbytes["bfloat16"])
    flops32, nbytes32, _ = mlp_work(cfg, cfg.chunk, S, wbytes["float32"])
    bound = {"bf16": max(flops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3,
             "f32": max(flops32 / PEAK_F32, nbytes32 / PEAK_BYTES) * 1e3}
    res.update(times, macs_per_point=macs, flops=flops, bytes=nbytes,
               bound_bf16_ms=bound["bf16"], bound_f32_ms=bound["f32"],
               bound_by_bf16=("operations" if flops / PEAK_BF16
                              >= nbytes / PEAK_BYTES else "bytes"),
               # achieved rate and the share of the bound reached
               bf16_tflops=flops / times["bf16_ms"] / 1e9,
               f32_tflops=flops32 / times["f32_ms"] / 1e9,
               bf16_bound_share=bound["bf16"] / times["bf16_ms"],
               f32_bound_share=bound["f32"] / times["f32_ms"],
               # registers, spill (local) bytes, dynamic shared memory and
               # residency of each kernel, read back from the runtime
               attrs={dt: kernel_attrs(dt == "bf16", cfg.view_num)
                      for dt in ("bf16", "f32")})
    log("k1", **res)
    return res


def phase_serving(cfg, dev):
    """>= 3 requests through ucnerf_torch.serve's batch mode, then one frame
    again with the plain MLP (bf16 and f32) for the kernel-vs-plain diff."""
    from ucnerf_torch import serve
    from ucnerf_torch.kernels.fused_mlp import FusedNeRFMLP, fused_nerf_mlp
    from ucnerf_torch.data import build_dataset
    from ucnerf_torch.models.factory import create_models
    from ucnerf_torch.render.renderer import render_image_chunked
    from ucnerf_torch.train.loop import prepare_view_ctx, view_chunk_fns

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    ds = build_dataset(cfg, "val")
    poses = [ds.scene[ds.metas[i][0]]["c2ws"][ds.metas[i][1]]
             for i in range(N_REQUESTS)]
    reqs = OUT_DIR / "requests.jsonl"
    outs = [str(OUT_DIR / f"frame_{i:03d}.npz") for i in range(N_REQUESTS)]
    with open(reqs, "w") as fh:
        for c2w, out in zip(poses, outs):
            fh.write(json.dumps({"c2w": np.asarray(c2w).tolist(),
                                 "out": out}) + "\n")
        fh.write('{"c2w": [[1, 2], [3, 4]], "out": "bad.npz"}\n')

    buf = io.StringIO()
    fused_nerf_mlp.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        n = serve.main(["--requests", str(reqs), *SERVE_ARGS])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_nerf_mlp.launches
    lines = buf.getvalue().splitlines()
    (OUT_DIR / "serve_stdout.txt").write_text(buf.getvalue())
    summary = json.loads(next(ln for ln in lines if ln.startswith('{"frames"')))
    errors = [ln for ln in lines if ln.startswith('{"error"')]
    n_tiles = -(-cfg.img_wh[0] * cfg.img_wh[1] // cfg.chunk)
    check(n == N_REQUESTS and len(errors) == 1,
          f"serve answered {n} requests, errors {errors}")
    check(launches == (N_REQUESTS + 1) * n_tiles,    # + the warm-up frame
          f"K1 launches {launches}, expected {(N_REQUESTS + 1) * n_tiles}")
    W, H = cfg.img_wh
    frames = [np.load(o) for o in outs]
    for i, f in enumerate(frames):
        check(f["rgb"].shape == (H, W, 3) and f["depth"].shape == (H, W)
              and f["confidence"].shape == (H, W), f"frame {i} shapes")
        check(all(np.isfinite(f[k]).all()
                  for k in ("rgb", "depth", "confidence")),
              f"frame {i} is not finite")
        check(f["rgb"].min() >= 0.0 and f["rgb"].max() <= 1.0,
              f"frame {i} rgb outside [0, 1]")

    # steady-state frame time and kernel-vs-plain frames on request 0
    renderer, _ = serve.build_renderer(cfg)
    c2w = np.asarray(poses[0], np.float32)
    with torch.no_grad():
        ms_frame = time_ms(lambda: renderer.render(c2w), iters=5, warmup=1)
        profile = profile_frame(lambda: renderer.render(c2w))
    # both MLPs render from ONE cascade output, so the diff is the MLP's
    # alone (the cascade's cuDNN convolutions need not be bit-reproducible)
    diffs = {}
    params = serve.load_params(cfg, dev)
    batch = renderer.frame_batch(c2w)
    for dt in ("bfloat16", "float32"):
        c = cfg.replace(nerf_dtype=dt)
        nerf, mvs = create_models(c, dev, params)
        got = {}
        with torch.no_grad():
            src = mvs.features(batch["images"][1:])
            ctx = prepare_view_ctx(
                c, mvs, batch, mvs_apply=lambda imgs, a, ai, n, f, p:
                mvs.from_features(src, a, ai, n, f, p))
            for name, mlp in (("kernel", FusedNeRFMLP(nerf)),
                              ("plain", nerf)):
                fns = view_chunk_fns(c, mlp, H, W, ctx)
                got[name] = [t.cpu().numpy() for t in render_image_chunked(
                    *fns, H, W, c.chunk, dev)]
        d_rgb = np.abs(got["kernel"][0] - got["plain"][0])
        d_depth = np.abs(got["kernel"][1] - got["plain"][1])
        diffs[dt] = dict(rgb_max_abs=float(d_rgb.max()),
                         rgb_mean_abs=float(d_rgb.mean()),
                         depth_max_abs=float(d_depth.max()),
                         depth_mean_rel=float((d_depth / np.abs(
                             got["plain"][1]).clip(1e-6)).mean()))
    fused_nerf_mlp.launches = launches   # comparison launches do not count
    check(diffs["float32"]["rgb_max_abs"] <= 1e-3
          and diffs["float32"]["depth_mean_rel"] <= 1e-4,
          f"f32 kernel frame vs plain frame: {diffs}")
    check(diffs["bfloat16"]["rgb_mean_abs"] <= 5e-3
          and diffs["bfloat16"]["depth_mean_rel"] <= 5e-3,
          f"bf16 kernel frame vs plain frame: {diffs}")
    res = dict(requests=n, frames_ok=len(frames), launches=launches,
               launches_per_frame=launches // (N_REQUESTS + 1),
               serve_ms_per_frame=summary["ms_per_frame"],
               serve_wall_s=wall, steady_ms_per_frame=ms_frame,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               kernel_vs_plain_frame=diffs, frame_profile=profile)
    log("serving", **res)
    return res


def main():
    sys.path.insert(0, str(ROOT))
    try:
        from ucnerf_torch.config import parse_config
    except ImportError as e:
        raise SystemExit(f"chip_smoke: the ucnerf_torch package is missing "
                         f"beside this script ({e})")
    smi = phase_device()
    dev = torch.device("cuda", 0)
    cfg = parse_config(SERVE_ARGS)
    phase_build()
    k1 = phase_k1(cfg, dev)
    sv = phase_serving(cfg, dev)
    record = {"k1": k1, "serving": sv, "nvidia_smi": smi}
    (OUT_DIR / "result.json").write_text(json.dumps(record, indent=1))
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "fused_nerf_mlp", "route": "cuda",
        "source": "ucnerf_torch/csrc/fused_mlp.cu",
        "replaces": "ucnerf_tpu/pallas/mlp_kernel.py:115",
        "launches": sv["launches"],
        "max_abs_err": k1["serving"]["bf16_vs_plain_bf16_max_abs_err"],
        "ms": k1["bf16_ms"], "plain_ms": k1["plain_bf16_ms"],
        "bound_ms": k1["bound_bf16_ms"], "bound_by": k1["bound_by_bf16"],
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
