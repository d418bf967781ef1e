"""Per-layer metric ``gather_ms.serve``: device milliseconds a frame in
index, gather and scatter kernels (featurization and ray building). Read
from the traced stretch's summary (``harness/trace.py``); None where the
trace holds no device kernel or no frame.
"""


def read(trace, cell):
    if cell["unit"] != "frame" or not trace["kernel_count"]:
        return None
    s = trace["families"].get("index_gather_scatter", 0.0)
    return 1e3 * s / trace["units"]
