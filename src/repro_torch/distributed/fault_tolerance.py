"""Straggler detection: the port of
``repro.distributed.fault_tolerance.StragglerMonitor``, which the serving
loop (``repro_torch.pregel.serve``) feeds each dispatch's wall time."""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np


@dataclasses.dataclass
class StragglerMonitor:
    """Flags steps (or hosts, when fed per-host times) that exceed
    median * threshold over a sliding window."""

    window: int = 50
    threshold: float = 1.75
    min_samples: int = 10
    times: List[float] = dataclasses.field(default_factory=list)
    flags: int = 0
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    def record(self, step: int, seconds: float) -> bool:
        """Record one time; True when it is an outlier against the
        median of the window before it."""
        self.times.append(seconds)
        hist = self.times[-self.window:]
        if len(hist) < self.min_samples:
            return False
        med = float(np.median(hist[:-1]))
        is_straggler = seconds > self.threshold * med
        if is_straggler:
            self.flags += 1
            if self.on_straggler:
                self.on_straggler(step, seconds, med)
        return is_straggler

    @property
    def median(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0
