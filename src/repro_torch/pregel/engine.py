"""Engine — the execution session for VertexPrograms.

The port of ``repro.pregel.engine`` as far as the ported slices need:
``Engine.run(prog, pg)`` runs the program's init, the superstep loop in
the engine's mode and ``prog.extract``; ``Engine.run_batch(prog, pg,
queries)`` runs Q query instances of a batchable program in one
host-driven loop (the batched query plane).

Modes (``repro_torch.pregel.runtime``): ``"host"`` runs a step per
Python iteration; ``"fused"`` and ``"chunked"`` run the loop on the
device, K = ``chunk_size`` supersteps a CUDA graph replay, every
program's inner loops (pointer jumping, label propagation, the
Propagation channel) as WHILE nodes inside it. The default stays
``"host"``, unlike the JAX package's ``"fused"``: ``run_batch`` has no
device modes yet, so a ``"fused"`` default would make it raise. The
default flips with the batched plane's device loop (ROADMAP, queue 1,
item 4.2).

A device mode's loop (its warm-up step and its captured graph) is cached
per (program, graph object, mode, chunk size, ``max_steps``,
``check_overflow``) — the counterpart of the JAX compile cache, with
``cache_hit`` and ``engine_compiles`` on every result; a hit replays the
graph with no warm-up and no capture. :meth:`Engine.clear_cache` drops
the cached loops and their graph memory. The planner (``plan="auto"``),
overflow escalation, checkpoints and serving are not ported yet
(ROADMAP) and raise ``NotImplementedError``; so do batched runs in the
device modes.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

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
    return NotImplementedError(f"{what} is not ported yet (see ROADMAP)")


class Engine:
    """Session for running VertexPrograms on one device.

    mode: ``"host"`` (the default here), ``"fused"`` or ``"chunked"``.
    chunk_size: K, the supersteps one dispatch of a device mode covers
      (default 64, as in the JAX package).
    device: where the graphs it runs must live (None = CUDA; raises when
      CUDA is absent). Pass ``"cpu"`` for the plain PyTorch path.
    """

    def __init__(self, mode: Optional[str] = None, device=None,
                 plan: Any = "manual", on_overflow: str = "raise",
                 chunk_size: Optional[int] = None):
        mode = "host" if mode is None else mode
        if mode not in runtime.MODES:
            raise ValueError(f"unknown execution mode {mode!r}")
        if plan != "manual":
            raise _not_ported(f"plan={plan!r}")
        if on_overflow != "raise":
            raise _not_ported(f"on_overflow={on_overflow!r}")
        self.mode = mode
        self.chunk_size = 64 if chunk_size is None else int(chunk_size)
        if self.chunk_size < 1:
            raise ValueError(f"chunk_size must be at least 1, got "
                             f"{self.chunk_size}")
        self.device: torch.device = resolve_device(device)
        self._cache: Dict[Tuple, runtime.DeviceLoop] = {}
        self.compiles = 0
        self.cache_hits = 0

    @property
    def cache_size(self) -> int:
        return len(self._cache)

    def clear_cache(self) -> None:
        """Drop every cached device loop: its CUDA graph, the graph's
        memory pool and its kernels' scratch."""
        for loop in self._cache.values():
            loop.release()
        self._cache.clear()

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
        ``output`` set to ``prog.extract(pg, state)``; in a device mode
        also the cache state (``cache_hit``, ``engine_compiles``,
        ``engine_cache_hits``) and, on a miss, ``compile_time_s``."""
        if checkpoint_every is not None or resume is not None:
            raise _not_ported("checkpoint/resume")
        self._check_device(pg)
        ms = prog.max_steps if max_steps is None else max_steps
        co = prog.check_overflow if check_overflow is None else check_overflow
        state0 = prog.init(pg)
        if self.mode == "host":
            res = runtime.run_supersteps(
                pg, prog.step, state0, max_steps=ms, check_overflow=co,
                channels=prog.channels)
        else:
            # the loop holds pg, so id(pg) names one live graph object
            key = (prog, id(pg), self.mode, self.chunk_size, ms, co)
            loop = self._cache.get(key)
            hit = loop is not None
            if hit:
                self.cache_hits += 1
            else:
                loop = runtime.DeviceLoop(
                    pg, prog.step, state0, mode=self.mode, max_steps=ms,
                    check_overflow=co, chunk_size=self.chunk_size,
                    channels=prog.channels, name=prog.name)
                self._cache[key] = loop
                self.compiles += 1
            res = loop.execute(state0)
            if not hit:
                res.compile_time_s = loop.compile_time_s
            res.cache_hit = hit
            res.engine_compiles = self.compiles
            res.engine_cache_hits = self.cache_hits
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
        if self.mode != "host":
            raise _not_ported(
                f"run_batch in mode={self.mode!r} (the batched plane's "
                "device loop, ROADMAP queue 1, item 4.2)")
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
