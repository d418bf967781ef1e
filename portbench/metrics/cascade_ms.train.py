"""Per-layer metric ``cascade_ms.train``: device milliseconds a step in the
cascade's convolution and normalization kernels, forward and backward.
Read from the traced stretch's summary (``harness/trace.py``); None where
the trace holds no device kernel or no train step.
"""

from portbench.harness.trace import CASCADE_FAMILIES


def read(trace, cell):
    if cell["unit"] != "step" or not trace["kernel_count"]:
        return None
    s = sum(trace["families"].get(f, 0.0) for f in CASCADE_FAMILIES)
    return 1e3 * s / trace["units"]
