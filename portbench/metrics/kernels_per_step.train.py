"""Per-layer metric ``kernels_per_step.train``: device operations (kernels,
copies and sets) launched a step. Read from the traced stretch's summary
(``harness/trace.py``); None where the trace holds no device operation or
no step.
"""


def read(trace, cell):
    if cell["unit"] != "step" or not trace["kernel_count"]:
        return None
    return trace["kernel_count"] / trace["units"]
