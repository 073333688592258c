"""Engine — the execution session for VertexPrograms.

The port of ``repro.pregel.engine`` as far as this slice needs:
``Engine.run(prog, pg)`` runs the program's init, the host-driven
superstep loop and ``prog.extract``. PyTorch runs eagerly, so there is no
compile cache to key. The fused/chunked modes, the planner
(``plan="auto"``), overflow escalation, checkpoints, batched queries and
serving are not ported yet (ROADMAP) and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.graph.pgraph import PartitionedGraph
from repro_torch.pregel import runtime
from repro_torch.pregel.program import VertexProgram


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (see ROADMAP: the port runs the "
        "host-driven loop only)")


class Engine:
    """Session for running VertexPrograms on one device.

    mode: only ``"host"`` (the default here) is ported.
    device: where the graphs it runs must live (None = CUDA; raises when
      CUDA is absent). Pass ``"cpu"`` for the plain PyTorch path.
    """

    def __init__(self, mode: Optional[str] = None, device=None,
                 plan: Any = "manual", on_overflow: str = "raise"):
        mode = "host" if mode is None else mode
        if mode in ("fused", "chunked"):
            raise _not_ported(f"mode={mode!r}")
        if mode not in runtime.MODES:
            raise ValueError(f"unknown execution mode {mode!r}")
        if plan != "manual":
            raise _not_ported(f"plan={plan!r}")
        if on_overflow != "raise":
            raise _not_ported(f"on_overflow={on_overflow!r}")
        self.mode = mode
        self.device: torch.device = resolve_device(device)

    def run(self, prog: VertexProgram, pg: PartitionedGraph, *,
            max_steps: Optional[int] = None,
            check_overflow: Optional[bool] = None,
            checkpoint_every: Optional[int] = None,
            resume: Any = None) -> runtime.RunResult:
        """Run ``prog`` on ``pg``. Returns the runtime's ``RunResult`` with
        ``output`` set to ``prog.extract(pg, state)``."""
        if checkpoint_every is not None or resume is not None:
            raise _not_ported("checkpoint/resume")
        if pg.device.type != self.device.type:
            raise ValueError(
                f"graph lives on {pg.device}, engine runs on {self.device}")
        ms = prog.max_steps if max_steps is None else max_steps
        co = prog.check_overflow if check_overflow is None else check_overflow
        res = runtime.run_supersteps(
            pg, prog.step, prog.init(pg), max_steps=ms, check_overflow=co,
            mode=self.mode, channels=prog.channels)
        res.program = prog.name
        res.output = prog.extract(pg, res.state)
        return res
