"""Per-layer metric ``kernels_per_frame.serve``: device operations (kernels,
copies and sets) launched a frame. Read from the traced stretch's summary
(``harness/trace.py``); None where the trace holds no device operation or
no frame.
"""


def read(trace, cell):
    if cell["unit"] != "frame" or not trace["kernel_count"]:
        return None
    return trace["kernel_count"] / trace["units"]
