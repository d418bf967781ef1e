"""Per-layer metric ``mfu.train``: the train step's model FLOPs (the
benchmark's frozen arithmetic, forward and backward) over the traced
stretch's wall time, as a share of the H100's dense bf16 peak. Read from
the traced stretch's summary (``harness/trace.py``); None where the trace
holds no device kernel or no train step.
"""

from portbench.reference import accounting


def read(trace, cell):
    if cell["unit"] != "step" or not trace["kernel_count"]:
        return None
    m = cell["model"]
    W, H = m.img_wh
    flops = accounting.train_step_flops(m, H, W) * trace["units"]
    return 100.0 * flops / trace["window_s"] / accounting.PEAK_BF16
