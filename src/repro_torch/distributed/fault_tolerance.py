"""Fault tolerance and straggler detection, the port of
``repro.distributed.fault_tolerance``.

- StragglerMonitor: per-step time tracker with robust outlier detection;
  the serving loop (``repro_torch.pregel.serve``) feeds it each
  dispatch's wall time, the training launcher each step's.
- TrainSupervisor: wraps the train loop with checkpoint/restart —
  periodic async checkpoints, crash-window replay from the deterministic
  data pipeline (batches are pure functions of step), and a
  preemption-safe final checkpoint.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import signal
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


@dataclasses.dataclass
class TrainSupervisor:
    """Checkpoint/restart supervisor around a step function.

    Usage:
        sup = TrainSupervisor(ckpt_dir, save_every=100)
        state, start = sup.restore_or(init_fn)
        for step in range(start, total):
            state, metrics = train_step(state, pipe.batch_at(step))
            sup.maybe_save(step, state)
    """

    ckpt_dir: str
    save_every: int = 100
    async_save: bool = True
    keep_last: int = 3
    _pending: Optional[object] = None
    _preempted: bool = False

    def install_preemption_handler(self):
        """Route SIGTERM to :attr:`preempted`; returns the handler it
        replaced, for the caller to put back when its loop ends."""
        def handler(signum, frame):
            self._preempted = True
        return signal.signal(signal.SIGTERM, handler)

    def restore_or(self, init_fn, target=None, shardings=None):
        """Returns (state, start_step): the newest checkpoint restored into
        ``target`` (default ``init_fn()``) if one exists, else
        ``init_fn()`` and 0. ``shardings`` waits for ROADMAP item 9.3."""
        from repro_torch.train import checkpoint as ckpt
        step = ckpt.latest_step(self.ckpt_dir)
        if step is None:
            return init_fn(), 0
        tgt = target if target is not None else init_fn()
        state = ckpt.restore(self.ckpt_dir, tgt, step=step,
                             shardings=shardings)
        return state, step + 1

    def maybe_save(self, step: int, state, force: bool = False):
        from repro_torch.train import checkpoint as ckpt
        due = force or self._preempted or (
            step > 0 and step % self.save_every == 0)
        if not due:
            return False
        if self._pending is not None:
            self._pending.join()  # one in-flight save at a time
        self._pending = ckpt.save(self.ckpt_dir, step, state,
                                  blocking=not self.async_save)
        self._gc()
        return True

    def finalize(self, step: int, state):
        """Join the save in flight, then save ``step`` blocking."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        from repro_torch.train import checkpoint as ckpt
        ckpt.save(self.ckpt_dir, step, state, blocking=True)

    def _gc(self):
        if not os.path.isdir(self.ckpt_dir):
            return
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.ckpt_dir)
                       if d.startswith("step_"))
        for s in steps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)

    @property
    def preempted(self) -> bool:
        return self._preempted
