"""What the traffic drivers share, and how a mix finds its driver.

A traffic mix (``portbench/traffic/<mix>.json``) is data: a ``kind`` and
the parameters of that kind's driver, ``portbench/drivers/<kind>.py``,
found by the name (``cells.resolve``).  A later mix of a kind that exists
adds one data file; a new kind adds one driver file.

A driver is a class ``Driver(config, traffic, seed, device)`` whose
set-up builds the program's state from the seed and warms up the cell's
shapes, with

- ``unit()``: one step or frame; returns the rays or frames it completed
  and whether its outputs were finite;
- ``totals(done, seconds)``: the end-to-end metrics of a window;
- ``check()``: frees the program's state and returns the numbers compared
  with the reference; after it ``control(precision)`` returns the same
  numbers of the reference computed at a lower precision in the
  program's place;
- ``spans``, ``unit_name``, ``traced_units`` for the traced stretch;
- ``setup_phases``: seconds of each stretch of its set-up
  (``SetupClock``).
"""

from __future__ import annotations

import time
from typing import Dict

import torch


class SetupClock:
    """Seconds of each named stretch of a driver's set-up (``phases``),
    each ended on a synchronized device, for the run's standard error."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.phases: Dict[str, float] = {}
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.phases[name] = now - self.t
        self.t = now


def program_config(config: Dict, **overrides):
    """The port's ``Config`` of a configuration file."""
    from ucnerf_torch.config import Config
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in config["model"].items()}
    kw.update(overrides)
    return Config(**kw)
