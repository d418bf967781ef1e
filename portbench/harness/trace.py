"""The traced stretch of a ``--trace 1`` run and its summary.

``torch.profiler`` (host and device activity) covers a fixed number of
steps or frames after the measured window, as the port's
``chip_smoke.py::profile_frame`` covers one frame.  The summary that the
per-layer readers (``portbench/metrics``) read:

- ``window_s``: the stretch's wall time; ``units``: steps or frames in it;
- ``busy_s``: the union of the device's kernel, copy and set intervals;
- ``kernels``: device seconds and launches by kernel name;
- ``families``: device seconds by kernel family (``KERNEL_FAMILIES``, the
  port's ``KERNEL_KINDS`` split finer);
- ``idle_by_span``: the device's idle seconds by the benchmark's span the
  host was in (the innermost one around the middle of each gap).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import torch

# device-time families by kernel name, first match wins
KERNEL_FAMILIES = (
    ("K1", ("fused_mlp",)),
    ("conv_wgrad", ("wgrad",)),
    ("batch_norm", ("batch_norm", "bn_fw", "bn_bw", "welford")),
    ("conv", ("cudnn", "conv", "dgrad", "fprop", "implicit_gemm",
              "fft2d", "winograd")),
    ("gemm", ("gemm", "cutlass", "cublas", "xmma")),
    ("index_gather_scatter", ("index", "gather", "scatter", "Radix",
                              "sort")),
    ("reduce", ("reduce",)),
    ("memcpy_memset", ("Memcpy", "Memset", "memcpy", "memset")),
)
OTHER = "elementwise_other"
# the cascade's layer: convolutions and normalization, forward and back
CASCADE_FAMILIES = ("conv_wgrad", "conv", "batch_norm")


def kernel_family(name: str) -> str:
    for family, keys in KERNEL_FAMILIES:
        if any(k in name for k in keys):
            return family
    return OTHER


def span(name: str):
    """A host span around one call into the program."""
    return torch.profiler.record_function(name)


def _merge(intervals: List) -> List:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(kernels: List, spans: List, w0: float, w1: float,
              units: int) -> Dict:
    """``kernels``: (name, start, end) of device operations; ``spans``:
    (name, start, end) of host spans; times in one clock (seconds); the
    stretch is [w0, w1]."""
    by_name: Dict[str, List] = {}
    clipped = []
    for name, s, e in kernels:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        clipped.append((s, e))
        rec = by_name.setdefault(name, [0.0, 0])
        rec[0] += e - s
        rec[1] += 1
    busy = _merge(clipped)
    busy_s = sum(e - s for s, e in busy)
    families: Dict[str, float] = {}
    for name, (sec, _) in by_name.items():
        fam = kernel_family(name)
        families[fam] = families.get(fam, 0.0) + sec
    gaps, at = [], w0
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if w1 > at:
        gaps.append((at, w1))
    idle: Dict[str, float] = {}
    for gs, ge in gaps:
        mid = 0.5 * (gs + ge)
        inside = [(e - s, n) for n, s, e in spans if s <= mid <= e]
        owner = min(inside)[1] if inside else "outside_spans"
        idle[owner] = idle.get(owner, 0.0) + (ge - gs)
    return dict(window_s=w1 - w0, units=units, busy_s=busy_s,
                kernels=by_name, families=families, idle_by_span=idle,
                kernel_count=sum(n for _, n in by_name.values()))


def trace_units(run_unit: Callable[[], object], units: int,
                span_names) -> Dict:
    """Profile ``units`` calls of ``run_unit`` and summarize them."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    sync = (torch.cuda.synchronize if torch.cuda.is_available()
            else (lambda: None))
    sync()
    with profile(activities=activities) as prof:
        with span("traced_window"):
            t0 = time.perf_counter()
            for _ in range(units):
                run_unit()
            sync()
            wall = time.perf_counter() - t0
    kernels, spans, window = [], [], None
    names = set(span_names)
    for ev in prof.events():
        s, e = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            # the device-side copies of host spans are not device work
            if not (getattr(ev, "is_user_annotation", False)
                    or ev.name in names or ev.name == "traced_window"):
                kernels.append((ev.name, s, e))
        elif ev.name == "traced_window":
            window = (s, e)
        elif ev.name in names:
            spans.append((ev.name, s, e))
    if window is None:
        raise RuntimeError("the profiler recorded no traced_window span")
    out = summarize(kernels, spans, window[0], window[1], units)
    out["wall_s"] = wall
    return out


def breakdown(summary: Dict, top: int = 10) -> Dict:
    """The result line's ``breakdown``: device seconds by kernel family
    and idle seconds by host span, the largest first."""
    def largest(d):
        return [[k, v] for k, v in sorted(d.items(),
                                          key=lambda kv: -kv[1])[:top]]
    return {"device_ops": largest(summary["families"]),
            "idle_gaps": largest(summary["idle_by_span"])}
