"""Engine — the execution session for VertexPrograms.

The port of ``repro.pregel.engine`` as far as the ported slices need:
``Engine.run(prog, pg)`` runs the program's init, the superstep loop in
the engine's mode and ``prog.extract``; ``Engine.run_batch(prog, pg,
queries)`` runs Q query instances of a batchable program in one loop
(the batched query plane); ``Engine.serve(prog, pg, requests)`` serves a
stream of queries through a fixed set of lanes, refilled as their
queries halt (``repro_torch.pregel.serve``).

Modes (``repro_torch.pregel.runtime``): ``"fused"`` (the default, as in
the JAX package) and ``"chunked"`` run the loop on the device, K =
``chunk_size`` supersteps a CUDA graph replay, every program's inner
loops (pointer jumping, label propagation, the Propagation channel) as
WHILE nodes inside it; ``"host"`` runs a step per Python iteration, one
readback a step. ``run_batch`` runs in all three; ``serve`` always runs
the chunked serving substrate, whatever the engine's mode.

The data-plane knobs: ``route_batch`` (``"union"``, the default, or
``"lane"``: how a batch's routed channels share their route passes
across the query lanes) and ``dense_threshold`` (the density switch's
frontier fraction). The port has one implementation per device, so the
JAX engine's ``use_kernel`` and ``route_impl`` are no constructor knobs
here: every wrapper launches its CUDA kernel on a card tensor and runs
its plain version on a CPU tensor, and every route takes the bucket
ranks. They stay fields of a ``Plan``, for the JSON layout the JAX
package shares; an ``Engine`` on the card refuses a given ``Plan`` with
``use_kernel=False`` or ``route_impl="sort"``, and on the CPU, where both
values name plain paths whose outputs are bit-identical, it records them.

``plan`` says where the knobs come from (``repro_torch.plan``):
``"manual"`` (the default) takes the constructor's knobs through each
knob's config ladder; ``"auto"`` asks the cost-model planner per
(program, graph shape, Q), before any loop is built and never inside a
capture, without touching :meth:`stats`; a ``Plan`` is used as given.
Knobs the caller set explicitly win under every policy. Every result
carries the ``Plan`` it ran under (``RunResult.plan``,
``ServeResult.plan``), and every loop runs under its knobs
(``runtime.knob_scope``).

A device mode's loop (its warm-up step and its captured graph) is cached
per (program, graph object, ``max_steps``, ``check_overflow``, capacity
scales) and the resolved ``Plan.key()`` (mode, chunk size and the
data-plane knobs, which a capture freezes), so a planned run and the
identical hand-set run share one loop; a batched loop also per bucket
cap, a serving loop per lane count and serve chunk — the counterpart of
the JAX compile cache, with ``cache_hit`` and ``engine_compiles`` on
every result; a hit replays the graph with no warm-up and no capture.
:meth:`Engine.clear_cache` drops the cached loops and their graph
memory; :meth:`Engine.stats` counts them.

Resilience, as in the JAX engine:

  - ``on_overflow="escalate"`` (with ``cap_scales`` and ``max_retries``):
    a ``ChannelOverflowError`` doubles the capacity scale of each channel
    it names (the ``"*"`` wildcard when it names none) and the run starts
    again, up to ``max_retries`` times. Each escalation builds (on the
    card: captures) a loop for the new scales; the loop of the scales
    that overflowed is released, since a learned scale never goes back
    down. ``RunResult.recovery`` lists the escalations, and the final
    scales are remembered per problem fingerprint
    (``repro_torch.plan.features``), so the next run of the same problem
    starts right-sized: a cache hit with no recovery.
  - ``checkpoint_every``/``checkpoint_dir``/``resume`` on
    :meth:`Engine.run` (chunked mode): chunk-boundary snapshots, and a
    resume bit-identical to the uninterrupted run
    (``repro_torch.pregel.checkpoint``).
  - ``on_nonconverged``: ``None`` (``RunResult.converged`` only),
    ``"warn"`` or ``"raise"`` (``NonConvergenceError``) when a run spends
    its ``max_steps`` without a unanimous halt vote.

Backends (``repro_torch.distributed.workers``): ``"local"`` (the
default; the JAX engine's ``"vmap"``) runs all W workers in this process,
W the leading dim of every tensor; ``"dist"`` (the JAX ``"shard_map"``)
runs one worker a process of a ``torch.distributed`` group of size W
(``group=``, the world group by default), each rank on a graph that
holds its own worker's rows (``pgraph.partition_graph(...,
worker=rank)``), every cross-worker operation a collective of the group,
bit-identical to ``"local"``. Every rank calls the same entry point with
the same arguments and gets the whole result: state and outputs of every
worker, and the group's bytes and messages. ``"dist"`` runs every mode,
solo (:meth:`Engine.run`) and batched (:meth:`Engine.run_batch`),
:meth:`Engine.serve`, checkpoints and ``plan="auto"``; under
``plan="manual"`` its mode defaults to ``"host"``. On a group the device
modes keep their results, chunk boundaries, stat rows, lane ages and
checkpoints, but not the capture: each rank runs the loop eagerly, since
a gloo collective cannot be captured (``runtime`` module docstring;
``RunResult.captured`` and ``ServeResult.captured`` are False there).
The capture on a group, NCCL with one card a rank, is ROADMAP item 8.2.
A group's checkpoint is written by rank 0 from the gathered state and
equals, byte for byte, the local run's at the same boundary, so either
backend resumes from the other's. Under ``plan="auto"`` the graph's
features are reduced over the group, rank 0 plans (probes and their
cache on rank 0 only) and broadcasts its ``Plan``, so every rank keys
the same loop under the local engine's ``Plan.key()``.
``repro_torch.launch.workers.spawn`` starts the ranks.

Under ``repro_torch.tracing.recording()`` each :meth:`Engine.run` is an
``engine.run`` span with the job's request id, holding ``engine.plan``,
``engine.init``, ``engine.execute`` and ``engine.extract``
(``engine.run_batch`` and ``engine.serve`` likewise), and drains the
device's stamps when it ends. Whether the sites stamp is part of every
cached loop's key: a loop captured while recording holds its stamps, and
only a recorded run replays it.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import torch

from repro_torch import tracing
from repro_torch.core import compose, routing
from repro_torch.device import resolve_device
from repro_torch.distributed import workers as workers_lib
from repro_torch.graph.pgraph import PartitionedGraph
from repro_torch.plan import features, planner as planning
from repro_torch.pregel import checkpoint as ckpt_io
from repro_torch.pregel import errors, runtime
from repro_torch.pregel import serve as serving
from repro_torch.pregel.program import VertexProgram


def bucket_queries(q: int) -> int:
    """Pow2 batch cap: the query-axis width for a Q-query batch (fixed
    shapes per bucket, as the JAX package compiles one executable per
    bucket)."""
    if q < 1:
        raise ValueError(f"need at least one query, got {q}")
    return 1 << (q - 1).bit_length()


class Engine:
    """Session for running VertexPrograms on one device.

    mode: ``"fused"`` (the default), ``"chunked"`` or ``"host"``.
    chunk_size: K, the supersteps one dispatch of a device mode covers
      (default 64, as in the JAX package).
    device: where the graphs it runs must live (None = CUDA; raises when
      CUDA is absent). Pass ``"cpu"`` for the plain PyTorch path.
    route_batch, dense_threshold: the data-plane knobs (None:
      ``REPRO_ROUTE_BATCH``/``REPRO_DENSE_THRESHOLD``, else ``"union"``,
      0.1).
    plan: ``"manual"``, ``"auto"`` or a ``repro_torch.plan.Plan``.
    on_overflow: ``"raise"`` or ``"escalate"``; cap_scales: the starting
      channel-capacity scales (a channel's full name or ``"*"`` to a
      factor); max_retries: the escalations a run may take.
    on_nonconverged: ``None``, ``"warn"`` or ``"raise"``.
    backend: ``"local"`` (all W workers in this process) or ``"dist"``
      (one worker a rank of ``group``, a ``torch.distributed``
      ``ProcessGroup``; None = the world group; the device modes run
      uncaptured there).
    """

    BACKENDS = ("local", "dist")

    def __init__(self, mode: Optional[str] = None, device=None,
                 plan: Any = "manual", on_overflow: str = "raise",
                 chunk_size: Optional[int] = None,
                 route_batch: Optional[str] = None,
                 on_nonconverged: Optional[str] = None,
                 cap_scales: Optional[Dict[str, float]] = None,
                 max_retries: int = 8,
                 dense_threshold: Optional[float] = None,
                 backend: str = "local", group=None):
        if mode is not None and mode not in runtime.MODES:
            raise ValueError(f"unknown execution mode {mode!r}")
        if backend not in self.BACKENDS:
            raise ValueError(f"unknown backend {backend!r} (one of "
                             f"{self.BACKENDS})")
        if backend == "dist":
            if mode is None and plan == "manual":
                mode = "host"
        elif group is not None:
            raise ValueError('group= needs backend="dist"')
        self.backend = backend
        if not (plan in ("manual", "auto")
                or isinstance(plan, planning.Plan)):
            raise ValueError(
                f"unknown plan {plan!r} (one of ('manual', 'auto') or a "
                "repro_torch.plan.Plan)")
        if on_overflow not in ("raise", "escalate"):
            raise ValueError(
                f"unknown on_overflow {on_overflow!r} "
                "(one of ('raise', 'escalate'))")
        if on_nonconverged not in (None, "warn", "raise"):
            raise ValueError(
                f"unknown on_nonconverged {on_nonconverged!r} "
                "(one of (None, 'warn', 'raise'))")
        self.on_overflow = on_overflow
        self.on_nonconverged = on_nonconverged
        self.max_retries = int(max_retries)
        self._base_scales = self._norm_scales(cap_scales or {})
        # learned capacity scales: fingerprint.cache_key() -> scales
        self._learned: Dict[str, Dict[str, float]] = {}
        self.runs = 0
        # the knobs the caller set: they win under every plan policy
        self._explicit = {
            "mode": mode, "chunk_size": chunk_size,
            "route_batch": route_batch, "dense_threshold": dense_threshold,
        }
        self.mode = "fused" if mode is None else mode
        self.chunk_size = 64 if chunk_size is None else int(chunk_size)
        if self.chunk_size < 1:
            raise ValueError(f"chunk_size must be at least 1, got "
                             f"{self.chunk_size}")
        self.device: torch.device = resolve_device(device)
        self.route_batch = routing.resolve_batch(route_batch)
        self.dense_threshold = compose.resolve_dense_threshold(
            dense_threshold)
        self.plan_policy = plan
        self._planner = planning.Planner() if plan == "auto" else None
        self._manual_plan: Optional[planning.Plan] = None
        if isinstance(plan, planning.Plan):
            self._check_legal(plan)
        self._cache: Dict[Tuple, runtime.DeviceLoop] = {}
        self.compiles = 0
        self.cache_hits = 0
        self.workers = (workers_lib.GroupWorkers(group)
                        if backend == "dist" else None)

    @property
    def cache_size(self) -> int:
        return len(self._cache)

    def stats(self) -> Dict[str, int]:
        return {"compiles": self.compiles, "cache_hits": self.cache_hits,
                "cached_executables": self.cache_size, "runs": self.runs}

    def clear_cache(self) -> None:
        """Drop every cached device loop: its CUDA graph, the graph's
        memory pool and its kernels' scratch."""
        for loop in self._cache.values():
            loop.release()
        self._cache.clear()

    # -- planning -------------------------------------------------------------

    def _overrides(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k, raw in self._explicit.items()
                if raw is not None}

    def _check_legal(self, plan: planning.Plan) -> None:
        """Refuse a given Plan that names a plain path on the card: the
        kernels are the only implementation a CUDA tensor takes (the
        planner keeps to them by itself)."""
        if self.device.type != "cuda":
            return
        if not plan.use_kernel:
            raise ValueError(
                f"Engine on {self.device}: the given plan's use_kernel="
                "False — the plain versions run only on the CPU; the card "
                "runs the kernels")
        if plan.route_impl != "bucket":
            raise ValueError(
                f"Engine on {self.device}: the given plan's route_impl="
                f"{plan.route_impl!r} — the sort baseline runs only on the "
                "CPU; the card routes through the bucket kernels")

    def resolve_plan(self, prog: VertexProgram, pg: PartitionedGraph,
                     num_queries: int = 0) -> planning.Plan:
        """The Plan a run of ``prog`` on ``pg`` (Q query lanes) runs
        under, per the engine's plan policy. Explicit constructor knobs
        win under every policy; ``"auto"`` consults the cost-model
        planner (its probes are cached on disk, never in this engine's
        cache, never in ``stats()``)."""
        if self.plan_policy == "auto":
            return self._auto_plan(prog, pg, num_queries)
        if isinstance(self.plan_policy, planning.Plan):
            return self._given_plan()
        return self._manual()

    def _auto_plan(self, prog, pg, num_queries: int) -> planning.Plan:
        """The planner's Plan; on a group, rank 0's, broadcast: the
        fingerprint holds the whole graph's features (reduced over the
        group), rank 0 alone probes and writes the probe cache, and every
        rank runs the one Plan."""
        fp = features.fingerprint(prog, pg, num_queries=num_queries,
                                  workers=self.workers)
        if self.workers is not None and self.workers.rank != 0:
            return self.workers.broadcast(None)
        plan = self._planner.plan(prog, pg, num_queries=num_queries,
                                  overrides=self._overrides(),
                                  fingerprint=fp)
        if self.workers is not None:
            plan = self.workers.broadcast(plan)
        return plan

    def _manual(self) -> planning.Plan:
        if self._manual_plan is None:
            self._manual_plan = planning.manual_plan(
                mode=self.mode, chunk_size=self.chunk_size,
                route_batch=self.route_batch,
                dense_threshold=self.dense_threshold,
                explicit=self._explicit)
        return self._manual_plan

    def _given_plan(self) -> planning.Plan:
        """A caller-supplied Plan, with any explicit constructor knobs
        replacing the plan's choices (explicit still wins)."""
        base = self.plan_policy
        over = self._overrides()
        if not over:
            return base
        decisions = tuple(
            planning.Decision(
                knob=d.knob, chosen=over[d.knob], source="explicit",
                candidates=d.candidates,
                reason="engine-constructor knob overrides the given plan")
            if d.knob in over else d
            for d in base.decisions)
        return dataclasses.replace(base, decisions=decisions, **over)

    def _check_device(self, pg: PartitionedGraph) -> None:
        if pg.device.type != self.device.type:
            raise ValueError(
                f"graph lives on {pg.device}, engine runs on {self.device}")
        if self.workers is None:
            if pg.worker is not None:
                raise ValueError(
                    f"graph holds worker {pg.worker}'s rows only: the "
                    'local backend runs every worker (backend="dist" runs '
                    "one a rank)")
            return
        if self.workers.size != pg.num_workers:
            raise ValueError(
                f"dist backend needs one worker per rank of the group: "
                f"graph has W={pg.num_workers}, group size "
                f"{self.workers.size}")
        if pg.worker != self.workers.rank:
            raise ValueError(
                f"rank {self.workers.rank} of the group runs worker "
                f"{self.workers.rank}: build its graph with worker="
                f"{self.workers.rank}, not {pg.worker}")

    # -- resilience: capacity-scale escalation -------------------------------

    @staticmethod
    def _norm_scales(scales: Dict[str, float]) -> Dict[str, float]:
        """The canonical form of a cap_scales dict: entries equal to the
        wildcard are dropped, so an escalation that lands back on the
        default capacities keys the same cached loop as a plain run."""
        base = float(scales.get("*", 1.0))
        out: Dict[str, float] = {}
        if base != 1.0:
            out["*"] = base
        for k, v in scales.items():
            if k != "*" and float(v) != base:
                out[k] = float(v)
        return out

    def _fingerprint_key(self, prog, pg, num_queries: int) -> str:
        return features.fingerprint(prog, pg, num_queries=num_queries,
                                    workers=self.workers).cache_key()

    def _effective_scales(self, prog, pg, num_queries: int
                          ) -> Dict[str, float]:
        """The constructor's scales merged with those an earlier
        escalation learned for this (program, graph shape, Q) problem."""
        scales = dict(self._base_scales)
        if self.on_overflow == "escalate":
            learned = self._learned.get(
                self._fingerprint_key(prog, pg, num_queries), {})
            for k, v in learned.items():
                if v > scales.get(k, scales.get("*", 1.0)):
                    scales[k] = v
        return self._norm_scales(scales)

    def _escalated(self, scales: Dict[str, float],
                   channels: Sequence[str]) -> Dict[str, float]:
        """Double the capacity scale of every overflowed channel (the
        scaled capacity re-buckets to the next power of two); an overflow
        with no channel named escalates the wildcard."""
        out = dict(scales)
        for name in (list(channels) or ["*"]):
            out[name] = out.get(name, out.get("*", 1.0)) * 2.0
        return self._norm_scales(out)

    def _release(self, prog, pg, scales: Dict[str, float]) -> None:
        """Drop the cached loops of ``prog`` on ``pg`` under ``scales``
        (they overflowed; a learned scale never goes back down)."""
        tag = tuple(sorted(scales.items()))
        for key in [k for k in self._cache
                    if k[0] is prog and k[1] == id(pg) and k[2] == tag]:
            self._cache.pop(key).release()

    def _with_escalation(self, prog, pg, num_queries: int,
                         attempt: Callable[[Dict[str, float]], Any]):
        """``attempt(scales)`` under the overflow policy: on
        ``ChannelOverflowError`` and ``on_overflow="escalate"``, escalate
        the named channels and try again, up to ``max_retries`` times.
        The escalation log lands on ``recovery`` (on the error's partial
        result when the retries run out)."""
        scales = self._effective_scales(prog, pg, num_queries)
        recovery: List[Dict[str, Any]] = []
        while True:
            try:
                res = attempt(scales)
                break
            except errors.ChannelOverflowError as err:
                if (self.on_overflow != "escalate"
                        or len(recovery) >= self.max_retries):
                    if recovery and err.result is not None:
                        err.result.recovery = recovery
                    raise
                self._release(prog, pg, scales)
                scales = self._escalated(scales, err.channels)
                event = {"attempt": len(recovery),
                         "superstep": err.superstep,
                         "channels": tuple(err.channels)}
                if num_queries:
                    event["qids"] = tuple(err.qids)
                event["cap_scales"] = dict(scales)
                recovery.append(event)
        if recovery:
            res.recovery = recovery
            self._learned[self._fingerprint_key(prog, pg, num_queries)] = \
                dict(scales)
        return res

    def _check_converged(self, prog: VertexProgram, res) -> None:
        if self.on_nonconverged is None or res.converged:
            return
        msg = (f"program {prog.name!r} did not converge: the max_steps "
               f"budget ({res.steps} supersteps) ran out before every "
               "vertex voted to halt")
        if self.on_nonconverged == "raise":
            raise errors.NonConvergenceError(
                msg, superstep=res.steps, result=res)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)

    # -- execution -----------------------------------------------------------

    def _loop(self, key: Tuple, plan: planning.Plan,
              build: Callable[[], runtime.DeviceLoop]
              ) -> Tuple[runtime.DeviceLoop, bool]:
        """The cached device loop under ``key`` and ``plan.key()``, built
        on a miss; and whether it was a hit. A key starts (program,
        ``id(pg)``, sorted capacity scales, ...); the loop holds its
        graph, so ``id(pg)`` names one live graph object. It also holds
        whether a recording is open: a loop captured in one holds its
        stamps, and only a recorded run replays it."""
        recording = tracing.active() is not None
        key = key + (self.backend, recording) + plan.key()
        loop = self._cache.get(key)
        if loop is not None:
            self.cache_hits += 1
            return loop, True
        loop = self._cache[key] = build()
        self.compiles += 1
        return loop, False

    def _stamp(self, res, loop: runtime.DeviceLoop, hit: bool):
        if not hit:
            res.compile_time_s = loop.compile_time_s
        res.cache_hit = hit
        res.engine_compiles = self.compiles
        res.engine_cache_hits = self.cache_hits
        return res

    @staticmethod
    def _knobs(plan: planning.Plan) -> Dict[str, Any]:
        """The plan's data-plane knobs, as the runtime's loops take
        them."""
        return {"route_batch": plan.route_batch,
                "dense_threshold": plan.dense_threshold}

    def _limits(self, prog, max_steps, check_overflow) -> Tuple[int, bool]:
        return (prog.max_steps if max_steps is None else max_steps,
                prog.check_overflow if check_overflow is None
                else check_overflow)

    def run(self, prog: VertexProgram, pg: PartitionedGraph, *,
            max_steps: Optional[int] = None,
            check_overflow: Optional[bool] = None,
            checkpoint_every: Optional[int] = None,
            checkpoint_dir: Optional[str] = None,
            resume: Any = None) -> runtime.RunResult:
        """Run ``prog`` on ``pg``. Returns the runtime's ``RunResult`` with
        ``output`` set to ``prog.extract(pg, state)``; in a device mode
        also the cache state (``cache_hit``, ``engine_compiles``,
        ``engine_cache_hits``) and, on a miss, ``compile_time_s``.

        ``checkpoint_every=K`` snapshots the chunked carry into
        ``checkpoint_dir`` at the first chunk boundary at or past every K
        supersteps; ``resume`` (a checkpoint path or
        :class:`~repro_torch.pregel.checkpoint.Checkpoint`) goes on from
        such a boundary, bit-identical to the uninterrupted run, on the
        loop the engine has cached (no new capture). Both need
        ``mode="chunked"``. Under ``on_overflow="escalate"`` an overflow
        escalates and replays (``RunResult.recovery``). On a group rank 0
        writes the checkpoints (every worker's state, the file a local run
        writes) and each rank resumes its own worker's rows."""
        with tracing.span("engine.run", tracing.run_rid()):
            try:
                res = self._run_traced(prog, pg, max_steps, check_overflow,
                                       checkpoint_every, checkpoint_dir,
                                       resume)
            finally:
                tracing.drain()
        return res

    def _run_traced(self, prog, pg, max_steps, check_overflow,
                    checkpoint_every, checkpoint_dir, resume):
        with tracing.span("engine.plan"):
            ms, co = self._limits(prog, max_steps, check_overflow)
            self._check_device(pg)
            plan = self.resolve_plan(prog, pg)
        resume_carry = None
        if resume is not None:
            ckpt = (resume if isinstance(resume, ckpt_io.Checkpoint)
                    else ckpt_io.load(resume))
            ckpt.validate(prog.name, pg, ms)
            resume_carry = ckpt.carry()
        checkpoint_cb = None
        if checkpoint_every is not None:
            if checkpoint_dir is None:
                raise ValueError(
                    "checkpoint_every needs checkpoint_dir to write into")
            graph = ckpt_io.graph_hash(pg)

            def checkpoint_cb(snap):
                if self.workers is None or self.workers.rank == 0:
                    ckpt_io.save(ckpt_io.Checkpoint(
                        program=prog.name, graph=graph, max_steps=ms,
                        **snap), checkpoint_dir)
        if (checkpoint_every is not None or resume is not None) \
                and plan.mode != "chunked":
            raise ValueError(
                "checkpoint/resume needs the unbatched chunked substrate — "
                f"this engine runs mode={plan.mode!r}. Use "
                "Engine(mode='chunked') to checkpoint at dispatch "
                "boundaries.")
        res = self._with_escalation(
            prog, pg, 0, lambda scales: self._run(
                prog, pg, plan, ms, co, scales, checkpoint_every,
                checkpoint_cb, resume_carry))
        self._check_converged(prog, res)
        return res

    def run_many(self, prog: VertexProgram,
                 graphs: Iterable[PartitionedGraph], **kw) -> "ManyResults":
        """Run one program over many graphs; each graph after the first
        run on a graph object the engine holds replays its cached loop.
        The returned list exposes each item's cache outcome."""
        return ManyResults(self.run(prog, pg, **kw) for pg in graphs)

    def _run(self, prog, pg, plan, ms, co, scales, checkpoint_every,
             checkpoint_cb, resume):
        self.runs += 1
        with tracing.span("engine.init"):
            state0 = prog.init(pg)
        knobs = self._knobs(plan)
        with tracing.span("engine.execute"):
            if plan.mode == "host":
                knobs.pop("route_batch")
                res = runtime.run_supersteps(
                    pg, prog.step, state0, max_steps=ms, check_overflow=co,
                    channels=prog.channels, cap_scales=scales,
                    workers=self.workers, **knobs)
            else:
                loop, hit = self._loop(
                    (prog, id(pg), tuple(sorted(scales.items())), ms, co),
                    plan, lambda: runtime.DeviceLoop(
                        pg, prog.step, state0, mode=plan.mode, max_steps=ms,
                        check_overflow=co, chunk_size=plan.chunk_size,
                        channels=prog.channels, name=prog.name,
                        cap_scales=scales, workers=self.workers, **knobs))
                res = self._stamp(loop.execute(
                    state0, checkpoint_every=checkpoint_every,
                    checkpoint_cb=checkpoint_cb, resume=resume), loop, hit)
        res.program = prog.name
        res.plan = plan
        res.backend = self.backend
        with tracing.span("engine.extract"):
            res.output = prog.extract(pg, res.state)
        return res

    def _query_axis(self, prog: VertexProgram, pg: PartitionedGraph,
                    what: str) -> None:
        if prog.query_init is None:
            raise ValueError(
                f"program {prog.name!r} declares no query axis "
                f"(VertexProgram.query_init) — it cannot be {what}")
        self._check_device(pg)

    def run_batch(self, prog: VertexProgram, pg: PartitionedGraph,
                  queries: Sequence[Any], *,
                  max_steps: Optional[int] = None,
                  check_overflow: Optional[bool] = None
                  ) -> runtime.RunResult:
        """Run Q query instances of ``prog`` on ``pg`` in ONE loop, in the
        engine's mode (per-query halt voting; see
        ``runtime.run_batched_supersteps`` and
        ``runtime.BatchedDeviceLoop``).

        ``queries`` are the per-query problem inputs fed to
        ``prog.query_init(pg, query)`` (e.g. SSSP source vertices). The
        batch is padded to the pow2 bucket cap with lanes that start
        halted; they are sliced away before anything is reported. A
        device mode caches its loop per bucket cap, so nearby batch
        sizes replay one graph.

        Returns the RunResult with per-query views: ``outputs`` (list of
        Q extracted answers — also on ``output``), ``query_steps``,
        ``query_halted`` and ``query_bytes``/``query_msgs``; the
        dict-of-int totals cover the Q real queries only. Under
        ``on_overflow="escalate"`` an overflow escalates and replays, the
        overflowing lanes on each ``recovery`` entry (``qids``).
        """
        with tracing.span("engine.run_batch", tracing.run_rid()):
            try:
                return self._run_batch_traced(prog, pg, queries, max_steps,
                                              check_overflow)
            finally:
                tracing.drain()

    def _run_batch_traced(self, prog, pg, queries, max_steps,
                          check_overflow):
        self._query_axis(prog, pg, "batched")
        queries = list(queries)
        q = len(queries)
        cap = bucket_queries(q)
        per_query = [prog.query_init(pg, query) for query in queries]
        # pad lanes start halted, so their state is never read: reuse the
        # first query's (torch.stack copies anyway)
        per_query += [per_query[0]] * (cap - q)
        state0 = {k: torch.stack([s[k] for s in per_query], dim=1)
                  for k in per_query[0]}
        ms, co = self._limits(prog, max_steps, check_overflow)
        plan = self.resolve_plan(prog, pg, cap)
        res = self._with_escalation(
            prog, pg, cap, lambda scales: self._run_batch(
                prog, pg, plan, state0, q, cap, ms, co, scales))
        self._check_converged(prog, res)
        return res

    def _run_batch(self, prog, pg, plan, state0, q, cap, ms, co, scales):
        self.runs += 1
        knobs = self._knobs(plan)
        if plan.mode == "host":
            res = runtime.run_batched_supersteps(
                pg, prog.step, state0, q, max_steps=ms, check_overflow=co,
                channels=prog.channels, cap_scales=scales,
                workers=self.workers, **knobs)
        else:
            loop, hit = self._loop(
                (prog, id(pg), tuple(sorted(scales.items())), ms, co,
                 "batch", cap), plan,
                lambda: runtime.BatchedDeviceLoop(
                    pg, prog.step, state0, mode=plan.mode, max_steps=ms,
                    check_overflow=co, chunk_size=plan.chunk_size,
                    channels=prog.channels, name=prog.name,
                    cap_scales=scales, workers=self.workers, **knobs))
            res = self._stamp(loop.execute(state0, q), loop, hit)
        res.program = prog.name
        res.plan = plan
        res.backend = self.backend
        res.outputs = [
            prog.extract(pg, {k: v[:, qi] for k, v in res.state.items()})
            for qi in range(q)]
        res.output = res.outputs
        return res

    def serve(self, prog: VertexProgram, pg: PartitionedGraph, requests, *,
              num_lanes: int = 8, chunk_size: Optional[int] = None,
              max_steps: Optional[int] = None,
              check_overflow: Optional[bool] = None,
              faults: Optional[Sequence] = None,
              on_fault: str = "quarantine") -> serving.ServeResult:
        """Continuous-batching query service: serve a stream of queries
        through ``num_lanes`` always-on lanes, admitting from the queue at
        every chunk (dispatch) boundary as halted queries vacate their
        lanes (see ``repro_torch.pregel.serve``).

        ``requests`` is a :class:`~repro_torch.pregel.serve.QueryQueue`
        (arrival times in supersteps) or a plain iterable of query values
        (all arrive at t=0). Admission granularity is ``chunk_size``
        supersteps (default: the engine's chunk size). The session runs
        the chunked serving substrate (``runtime.BatchedDeviceLoop(serve=
        True)``) whatever the engine's mode; refills rewrite lane state
        in place between replays, and the loop is cached under (program,
        graph, lanes, chunk), so a second session of the same shape
        replays it warm (``cache_hit``).

        Every served query equals a solo run of it bit for bit (output,
        steps, per-channel traffic): each lane's age stands in for the
        step counter. ``on_fault="quarantine"`` (default) harvests a lane
        that overflows a channel with ``status="overflow"`` and recycles
        it; ``"raise"`` raises ``ChannelOverflowError`` with the failed
        qids. ``faults`` takes :class:`~repro_torch.pregel.serve.FaultSpec`
        injections. Returns a :class:`~repro_torch.pregel.serve.ServeResult`.
        """
        if on_fault not in ("quarantine", "raise"):
            raise ValueError(
                f"unknown on_fault {on_fault!r} "
                "(one of ('quarantine', 'raise'))")
        with tracing.span("engine.serve"):
            try:
                return self._serve(prog, pg, requests, num_lanes,
                                   chunk_size, max_steps, check_overflow,
                                   faults, on_fault)
            finally:
                tracing.drain()

    def _serve(self, prog, pg, requests, num_lanes, chunk_size, max_steps,
               check_overflow, faults, on_fault):
        self._query_axis(prog, pg, "served")
        if num_lanes < 1:
            raise ValueError(f"need at least one lane, got {num_lanes}")
        queue = serving.as_queue(requests)
        ms, co = self._limits(prog, max_steps, check_overflow)
        plan = self.resolve_plan(prog, pg, num_lanes)
        chunk = plan.chunk_size if chunk_size is None else chunk_size
        if len(queue) == 0:
            return serving.ServeResult(
                program=prog.name, records=[], num_lanes=num_lanes,
                chunk_size=chunk, max_steps=ms, supersteps=0, clock=0,
                dispatches=0, wall_time_s=0.0, bytes_by_channel={},
                msgs_by_channel={}, route_batch=plan.route_batch,
                cache_hit=True, engine_compiles=self.compiles,
                engine_cache_hits=self.cache_hits, plan=plan)
        # the lanes' layout comes from any query's state: every lane is
        # written on admission, and an unoccupied lane is dead (halted,
        # no traffic, out of the union route pass)
        template = prog.query_init(pg, queue.peek_query())
        state0 = {k: torch.stack([v] * num_lanes, dim=1)
                  for k, v in template.items()}
        self.runs += 1
        # the chunked serving substrate, whatever the plan's mode
        loop, hit = self._loop(
            (prog, id(pg), (), ms, co, "serve", num_lanes, chunk), plan,
            lambda: runtime.BatchedDeviceLoop(
                pg, prog.step, state0, mode="chunked", max_steps=ms,
                check_overflow=co, chunk_size=chunk, channels=prog.channels,
                name=prog.name, serve=True, workers=self.workers,
                **self._knobs(plan)))
        res = serving.serve_loop(loop, prog, pg, state0, queue,
                                 faults=faults, on_fault=on_fault)
        res.program = prog.name
        res.route_batch = plan.route_batch
        res.plan = plan
        return self._stamp(res, loop, hit)


class ManyResults(List[runtime.RunResult]):
    """``Engine.run_many``'s return value: a plain result list that also
    exposes each item's cache outcome."""

    @property
    def cache_hits(self) -> List[bool]:
        return [r.cache_hit for r in self]

    @property
    def hit_count(self) -> int:
        return sum(r.cache_hit for r in self)


def run_program(prog: VertexProgram, pg: PartitionedGraph, *,
                mode: Optional[str] = None, chunk_size: int = 64,
                max_steps: Optional[int] = None,
                check_overflow: Optional[bool] = None, device=None,
                route_batch: Optional[str] = None) -> runtime.RunResult:
    """One run on a throwaway Engine (on the graph's device unless
    ``device`` says otherwise)."""
    eng = Engine(mode=mode, chunk_size=chunk_size,
                 device=pg.device if device is None else device,
                 route_batch=route_batch)
    return eng.run(prog, pg, max_steps=max_steps,
                   check_overflow=check_overflow)
