"""Per-layer metric ``mfu.serve``: a served frame's model FLOPs (the three
CostRegNets and the MLP over every sample; the source views' FeatureNet
runs once at set-up) over the traced stretch's wall time, as a share of
the H100's dense bf16 peak. Read from the traced stretch's summary
(``harness/trace.py``); None where the trace holds no device kernel or no
frame.
"""

from portbench.reference import accounting


def read(trace, cell):
    if cell["unit"] != "frame" or not trace["kernel_count"]:
        return None
    m = cell["model"]
    W, H = m.img_wh
    flops = accounting.serve_frame_flops(m, H, W) * trace["units"]
    return 100.0 * flops / trace["window_s"] / accounting.PEAK_BF16
