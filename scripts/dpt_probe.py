"""The DPT-Hybrid forward of ``python -m ucnerf_torch.preprocess dpt`` on a
CUDA card under the backend settings that choose its kernels, at the net
size of a 1280x1024 SCARED frame (384x480), with the seeded weights.

    python3 scripts/dpt_probe.py

Rows: f32 with TF32 off (what ``chip_smoke.py`` measures), f32 with cuDNN's
benchmark mode, f32 in channels-last memory, f32 with TF32 on; bf16 as is,
with benchmark mode, and channels-last; then the depth head alone on the
trunk's map, f32 and bf16.  For each: ms per call (CUDA events, the mean
of 10 after 3 warm-ups), the peak device memory above what was allocated
before (of the trunk alone in the full-forward rows), the trunk's
rel-to-max difference to the first row's, and the device time by kernel
kind of one profiled call (``chip_smoke.profile_frame``; every kernel in
``chiprun_out/dpt_probe/<row>.txt``).  Prints the card's name and power
limit and one JSON line.  Needs one card; it is not part of
``chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "chiprun_out" / "dpt_probe"


@contextlib.contextmanager
def backends(tf32: bool = False, benchmark: bool = False):
    """cuDNN / cuBLAS settings for the block, restored after."""
    import torch
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cudnn.benchmark = benchmark
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.benchmark) = prev


def probe(dev, hw=(384, 480)) -> dict:
    """The rows on ``dev`` at net input ``hw``."""
    import torch
    import chip_smoke
    from ucnerf_torch.models import dpt

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    chip_smoke.OUT_DIR = OUT_DIR
    jax_layout = dpt.convert_dpt_torch_state_dict(
        dpt.seeded_dpt_state_dict(0))
    params = {m: dpt.to_torch_params(jax_layout, m, dev)
              for m in ("float32", "bfloat16")}
    x32 = torch.randn((1, 3) + tuple(hw), generator=torch.Generator()
                      .manual_seed(0)).to(dev)

    def channels_last(p):
        return {k: v.contiguous(memory_format=torch.channels_last)
                if v.ndim == 4 else v for k, v in p.items()}

    rows = {"f32": ("float32", {}, False),
            "f32_benchmark": ("float32", {"benchmark": True}, False),
            "f32_channels_last": ("float32", {}, True),
            "f32_tf32": ("float32", {"tf32": True}, False),
            "bf16": ("bfloat16", {}, False),
            "bf16_benchmark": ("bfloat16", {"benchmark": True}, False),
            "bf16_channels_last": ("bfloat16", {}, True)}
    out, ref = {}, None
    with torch.no_grad():
        for name, (dtype, flags, cl) in rows.items():
            p = channels_last(params[dtype]) if cl else params[dtype]
            x = x32.to(getattr(torch, dtype))
            if cl:
                x = x.contiguous(memory_format=torch.channels_last)
            with backends(**flags):
                ms = chip_smoke.time_ms(lambda: dpt.dpt_forward(p, x),
                                        iters=10, warmup=3)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                trunk = dpt._dpt_trunk(p, x).float()
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - base
                prof = chip_smoke.profile_frame(
                    lambda: dpt.dpt_forward(p, x), top=6,
                    name=f"{name}.txt")
            ref = trunk if ref is None else ref
            out[name] = dict(ms=ms, peak_gib=peak / 2 ** 30,
                             trunk_vs_f32=chip_smoke.rel_to_max(trunk, ref),
                             by_kind_ms=prof["by_kind_ms"],
                             n_device_kernels=prof["n_device_kernels"],
                             device_busy_ms=prof["device_busy_ms"],
                             top_kernels_ms=prof["top_kernels_ms"])
            del trunk
        # the depth head alone, on the trunk's map of each dtype
        for name, dtype in (("f32_head", "float32"),
                            ("bf16_head", "bfloat16")):
            p = params[dtype]
            with backends():
                fused = dpt._dpt_trunk(p, x32.to(getattr(torch, dtype)))
                ms = chip_smoke.time_ms(lambda: dpt._depth_head(p, fused),
                                        iters=10, warmup=3)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                dpt._depth_head(p, fused)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - base
                prof = chip_smoke.profile_frame(
                    lambda: dpt._depth_head(p, fused), top=6,
                    name=f"{name}.txt")
            out[name] = dict(ms=ms, peak_gib=peak / 2 ** 30,
                             by_kind_ms=prof["by_kind_ms"],
                             n_device_kernels=prof["n_device_kernels"],
                             device_busy_ms=prof["device_busy_ms"],
                             top_kernels_ms=prof["top_kernels_ms"])
    return out


def main() -> dict:
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke

    if not torch.cuda.is_available():
        raise SystemExit("dpt_probe: no CUDA device; this script needs the "
                         "card")
    smi = chip_smoke.phase_device()
    out = probe(torch.device("cuda", 0))
    print(smi)
    print(json.dumps({"dpt_probe": out, "input": [1, 3, 384, 480]}))
    return out


if __name__ == "__main__":
    main()
