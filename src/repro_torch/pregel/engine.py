"""Engine — the execution session for VertexPrograms.

The port of ``repro.pregel.engine`` as far as the ported slices need:
``Engine.run(prog, pg)`` runs the program's init, the host-driven
superstep loop and ``prog.extract``; ``Engine.run_batch(prog, pg,
queries)`` runs Q query instances of a batchable program in one
host-driven loop (the batched query plane). PyTorch runs eagerly, so
there is no compile cache to key. The fused/chunked modes, the planner
(``plan="auto"``), overflow escalation, checkpoints and serving are not
ported yet (ROADMAP) and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from repro_torch.device import resolve_device
from repro_torch.graph.pgraph import PartitionedGraph
from repro_torch.pregel import runtime
from repro_torch.pregel.program import VertexProgram


def bucket_queries(q: int) -> int:
    """Pow2 batch cap: the query-axis width for a Q-query batch (fixed
    shapes per bucket, as the JAX package compiles one executable per
    bucket)."""
    if q < 1:
        raise ValueError(f"need at least one query, got {q}")
    return 1 << (q - 1).bit_length()


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

    def _check_device(self, pg: PartitionedGraph) -> None:
        if pg.device.type != self.device.type:
            raise ValueError(
                f"graph lives on {pg.device}, engine runs on {self.device}")

    def run(self, prog: VertexProgram, pg: PartitionedGraph, *,
            max_steps: Optional[int] = None,
            check_overflow: Optional[bool] = None,
            checkpoint_every: Optional[int] = None,
            resume: Any = None) -> runtime.RunResult:
        """Run ``prog`` on ``pg``. Returns the runtime's ``RunResult`` with
        ``output`` set to ``prog.extract(pg, state)``."""
        if checkpoint_every is not None or resume is not None:
            raise _not_ported("checkpoint/resume")
        self._check_device(pg)
        ms = prog.max_steps if max_steps is None else max_steps
        co = prog.check_overflow if check_overflow is None else check_overflow
        res = runtime.run_supersteps(
            pg, prog.step, prog.init(pg), max_steps=ms, check_overflow=co,
            mode=self.mode, channels=prog.channels)
        res.program = prog.name
        res.output = prog.extract(pg, res.state)
        return res

    def run_batch(self, prog: VertexProgram, pg: PartitionedGraph,
                  queries: Sequence[Any], *,
                  max_steps: Optional[int] = None,
                  check_overflow: Optional[bool] = None
                  ) -> runtime.RunResult:
        """Run Q query instances of ``prog`` on ``pg`` in ONE host-driven
        loop (per-query halt voting; see
        ``runtime.run_batched_supersteps``).

        ``queries`` are the per-query problem inputs fed to
        ``prog.query_init(pg, query)`` (e.g. SSSP source vertices). The
        batch is padded to the pow2 bucket cap with lanes that start
        halted; they are sliced away before anything is reported.

        Returns the RunResult with per-query views: ``outputs`` (list of
        Q extracted answers — also on ``output``), ``query_steps``,
        ``query_halted`` and ``query_bytes``/``query_msgs``; the
        dict-of-int totals cover the Q real queries only.
        """
        if prog.query_init is None:
            raise ValueError(
                f"program {prog.name!r} declares no query axis "
                "(VertexProgram.query_init) — it cannot be batched")
        self._check_device(pg)
        queries = list(queries)
        q = len(queries)
        cap = bucket_queries(q)
        per_query = [prog.query_init(pg, query) for query in queries]
        # pad lanes start halted, so their state is never read: reuse the
        # first query's (torch.stack copies anyway)
        per_query += [per_query[0]] * (cap - q)
        state0 = {k: torch.stack([s[k] for s in per_query], dim=1)
                  for k in per_query[0]}
        ms = prog.max_steps if max_steps is None else max_steps
        co = prog.check_overflow if check_overflow is None else check_overflow
        res = runtime.run_batched_supersteps(
            pg, prog.step, state0, q, max_steps=ms, check_overflow=co,
            channels=prog.channels)
        res.program = prog.name
        res.outputs = [
            prog.extract(pg, {k: v[:, qi] for k, v in res.state.items()})
            for qi in range(q)]
        res.output = res.outputs
        return res
