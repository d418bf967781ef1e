"""Per-layer metric ``k1_roofline.serve``: kernel K1's least time (the larger
of the MLP's FLOPs at the MLP precision's peak and its bytes at 3.35 TB/s,
per tile of the frame) over its device time, in percent. Read from the
traced stretch's summary (``harness/trace.py``); None where the trace
holds no K1 launch.
"""

from portbench.reference import accounting


def read(trace, cell):
    k1_s = trace["families"].get("K1", 0.0)
    if cell["unit"] != "frame" or k1_s <= 0.0:
        return None
    m = cell["model"]
    W, H = m.img_wh
    chunk = cell["traffic"]["chunk"]
    bound = sum(accounting.k1_bound_seconds(m, min(chunk, H * W - start),
                                            m.N_samples)
                for start in range(0, H * W, chunk))
    return 100.0 * bound * trace["units"] / k1_s
