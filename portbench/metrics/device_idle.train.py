"""Per-layer metric ``device_idle.train``: the share of the traced stretch's
wall time in which no device operation ran, in percent. Read from the
traced stretch's summary (``harness/trace.py``); None where the trace
holds no device operation or no step.
"""


def read(trace, cell):
    if cell["unit"] != "step" or not trace["kernel_count"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
