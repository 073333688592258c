"""The worker runtime (paper Fig. 4): the superstep loop.

The port of ``repro.pregel.runtime``, with the W workers as the leading
dim of every tensor. Three execution modes drive the loop, as in the JAX
package, and give bit-identical results (outputs, supersteps, halt
flags, bytes and messages per channel, overflow and wrap errors):

  - ``host``: one step per Python iteration, then one blocking readback
    of the halt vote, the overflow latch and the per-channel traffic
    (:func:`run_supersteps`). Per-step counters are summed on the host in
    Python ints; a negative per-step total raises ``TrafficWrapError``.
  - ``fused``: the loop on the device (:class:`DeviceLoop`). A warm-up
    step on a clone of the state builds the kernels, sizes their scratch
    and fixes the stat keys (a ``channels=`` declaration still rules);
    then K supersteps over static state buffers are captured into one
    CUDA graph, each under an IF conditional node on the device flag
    ``go = ~halted & (i < max_steps) & ~overflow`` — the JAX package's
    ``lax.cond(stop, skip, do)``: a stopped step costs the node and no
    superstep's work. A superstep's inner loops (pointer jumping, label
    propagation, the Propagation channel's rounds and local fixpoints:
    ``core.channel.inner_loop``) are WHILE nodes inside its IF node, as
    deep as they nest, each with its condition on the device — the JAX
    package's ``lax.while_loop``. Each dispatch replays the graph; the
    host reads back four int32 flags between replays. The traffic
    accumulates on the device in int32, per worker, with a wrap latch
    that trips when an accumulator decreases (the JAX fused loop's
    contract and message); the totals come back once, at the end.
  - ``chunked``: the same graph, but each step writes its stat row, and
    one readback at each chunk boundary brings back the K rows; the host
    sums them in int64 and names the channel of a negative per-step
    count, as the JAX chunked mode does.

On the CPU (``device="cpu"``, the tests) the two device modes run the
same loop, chunk boundaries, accumulators, latches and readbacks with
``if go: step`` in place of the IF node and ``while cond: body`` in
place of each WHILE node (the condition read outside the guard), and
each step and each inner body under a guard that raises on the host
syncs a capture refuses (``.item()``/``bool()`` of a tensor,
``nonzero``, boolean-mask indexing and the like). On the card a failed
capture raises; nothing falls back to the eager loop.

Voting-to-halt: the step returns per-worker halt votes; the runtime ANDs
them (``aggregator.all_halted``).

Every loop also runs on a group (``workers``, a
``repro_torch.distributed.workers.GroupWorkers``; ``Engine(backend=
"dist")``): one worker a rank, the graph and state holding that worker's
rows, every cross-worker step a collective of the group. The host loop's
one readback a superstep is an ``all_gather`` of each rank's row, so
every rank sums the same totals and takes the same halt, overflow and
wrap verdicts. The device loops on a group do not capture, by
construction (not as a fallback: the local loop's capture failure still
raises): they run the K steps eagerly on the rank's device, as on the
CPU, each superstep's ``go`` and each inner loop's condition read on the
host; the halt and overflow votes that steer ``go`` are one
``all_gather`` a superstep, so every rank takes the same branch and
issues the same collectives in the same order; at each chunk boundary
every rank's flags, lane rows and stat rows are gathered
(``gather_host``) and merged into the local layout, so the totals, wrap
and overflow errors, checkpoints and lane ages equal the local run's.
``RunResult.captured`` says whether a replayed CUDA graph ran. The final
state is gathered to ``(W, ...)`` on every rank; a resume takes each
rank's own rows of a checkpoint's state. The capture on a group (NCCL,
one card a rank) is ROADMAP item 8.2.

Batched query plane (under ``Engine.run_batch``): one loop advances Q
query instances per superstep, state leaves ``(W, Q, n_loc, ...)``.
Halting is per query: a ``(Q,)`` halted mask lives on the device, a lane
that voted halt keeps its state bit for bit (a ``torch.where`` over the
pre-step live mask), sends nothing and is charged nothing from the next
step on — the halting step itself still charges, as a solo run would.
Pad lanes start halted. Host mode (:func:`run_batched_supersteps`) reads
back the ``(Q,)`` halt and overflow flags and the per-lane stats once a
superstep; the device modes (:class:`BatchedDeviceLoop`) run the same
step under the IF nodes of the captured graph, with the ``(Q,)`` flags
and ``(W, Q)`` stats in the loop's buffers. Per-lane totals are summed
on the host in int64. So per-query steps, outputs and per-channel
bytes/msgs are bit-identical to Q solo runs in every mode; overflow
raises ``ChannelOverflowError`` naming the offending lanes (``qids``).

The serving substrate (``Engine.serve``, ``repro_torch.pregel.serve``)
is the same batched loop built with ``serve=True``: always chunked, each
lane with its own age, halt and overflow words, so the host can harvest
and refill lanes between dispatches.

Every loop takes the data-plane knobs ``route_batch`` and
``dense_threshold`` (None: each knob's config ladder,
:func:`resolve_knobs`), resolved once when the loop is made, and runs
its warm-up, its capture and every host step under their scopes
(:func:`knob_scope`), as the JAX package traces its loop under them: on
the card they are frozen into the captured graph, so a loop is built per
knob set (``Engine`` keys its loops by the resolved ``Plan.key()``); the
result records them. Every loop takes ``cap_scales``
(``ChannelContext.cap_scales``: the capacity scales of
``Engine(on_overflow="escalate")``), so a loop is also built per scale
set. The chunked solo loop also checkpoints at chunk
boundaries and resumes from a checkpoint (:meth:`DeviceLoop.execute`,
``repro_torch.pregel.checkpoint``): the step goes into the counter the
captured steps read, never into a launch argument frozen at capture.
:func:`graph_signature` is a graph's static surface, which a checkpoint
records.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import aggregator, compose, routing
from repro_torch.core.channel import (ChannelContext, ChannelRegistry,
                                      DeviceLoopHooks, on_device, store)
from repro_torch.distributed import workers as workers_lib
from repro_torch.graph.pgraph import PartitionedGraph
from repro_torch.kernels import ops as kops
from repro_torch.kernels import graph_if, scratch
from repro_torch.pregel import errors

MODES = ("host", "fused", "chunked")


@dataclasses.dataclass
class RunResult:
    state: Any
    steps: int
    halted: bool
    bytes_by_channel: Dict[str, int]
    msgs_by_channel: Dict[str, int]
    wall_time_s: float
    # host clock per dispatch (a superstep in host mode, a replay of the
    # K-step loop in the device modes), each ending in its readback
    step_times_s: list
    mode: str = "host"
    # host-mode supersteps, or replays of the captured loop
    dispatches: int = 0
    # the warm-up step and the capture of a device loop; 0 for a run that
    # replayed an executable an earlier run paid for
    compile_time_s: float = 0.0
    # host time spent driving the run (enqueues, readbacks, bookkeeping),
    # without the waits for the device
    host_overhead_s: float = 0.0
    program: str = ""
    output: Any = None
    converged: bool = False
    # Engine compile-cache state at run time (device modes)
    cache_hit: bool = False
    engine_compiles: int = 0
    engine_cache_hits: int = 0
    # name -> bool, or name -> (Q,) bool for batched runs
    overflow_by_channel: Optional[Dict[str, Any]] = None
    # the data-plane knobs the loop ran under (resolve_knobs): the
    # density-switch threshold, and for batched runs how the routed
    # channels shared the lanes' route passes
    dense_threshold: float = 0.0
    route_batch: str = ""
    # the Plan the Engine ran under (repro_torch.plan.Plan: knobs,
    # source, fingerprint, decisions; JSON via plan.to_json()); None for
    # plain runtime calls
    plan: Any = None
    # Batched-query metadata (num_queries > 0 iff the loop carried a query
    # axis): host numpy views of the Q real lanes; bytes_by_channel and
    # msgs_by_channel hold their totals. ``outputs`` is the per-query
    # extracted answer list (Engine.run_batch).
    num_queries: int = 0
    query_steps: Any = None            # (Q,) int64
    query_halted: Any = None           # (Q,) bool
    query_bytes_by_channel: Optional[Dict[str, Any]] = None  # name->(Q,)
    query_msgs_by_channel: Optional[Dict[str, Any]] = None   # name->(Q,)
    outputs: Any = None
    # Pad-lane audit: the pow2 padding lanes start halted, so they never
    # step, occupy wire slots or get charged — all three stay zero
    num_pad_lanes: int = 0
    pad_steps: int = 0
    pad_bytes: int = 0
    pad_msgs: int = 0
    # the engine's escalation log (Engine(on_overflow="escalate")): one
    # dict an escalation, None when the run needed none
    recovery: Any = None
    # the superstep of the checkpoint a chunked run resumed from (0: it
    # ran from the start)
    resumed_from: int = 0
    # the engine's backend: "local" (every worker in this process) or
    # "dist" (one worker a rank of a torch.distributed group)
    backend: str = "local"
    # True only when the run replayed a captured CUDA graph (a device
    # mode on the card, every worker in this process); ``mode`` stays
    # what was asked for
    captured: bool = False

    @property
    def total_bytes(self) -> int:
        return int(sum(self.bytes_by_channel.values()))

    @property
    def total_msgs(self) -> int:
        return int(sum(self.msgs_by_channel.values()))

    def query_bytes(self, q: int) -> Dict[str, int]:
        """Per-channel byte totals attributed to query ``q``."""
        return {k: int(v[q]) for k, v in self.query_bytes_by_channel.items()}

    def query_msgs(self, q: int) -> Dict[str, int]:
        """Per-channel message totals attributed to query ``q``."""
        return {k: int(v[q]) for k, v in self.query_msgs_by_channel.items()}


def resolve_knobs(route_batch: Optional[str] = None,
                  dense_threshold: Optional[float] = None
                  ) -> Dict[str, Any]:
    """The data-plane knobs a loop runs under, each through its config
    ladder (explicit > scope > env > default)."""
    return {"route_batch": routing.resolve_batch(route_batch),
            "dense_threshold": compose.resolve_dense_threshold(
                dense_threshold)}


@contextlib.contextmanager
def knob_scope(knobs: Dict[str, Any]):
    """Pin ``knobs`` (:func:`resolve_knobs`) for every channel and kernel
    call under the scope."""
    with routing.batch_scope(knobs["route_batch"]), \
            compose.dense_threshold_scope(knobs["dense_threshold"]):
        yield


def _stamp_knobs(res: "RunResult", knobs: Dict[str, Any],
                 batched: bool = False) -> "RunResult":
    res.dense_threshold = knobs["dense_threshold"]
    if batched:
        res.route_batch = knobs["route_batch"]
    return res


def _readback(workers, halt_all, overflow, nbytes, nmsgs, novf):
    """One device-to-host copy of everything the loop reads per step —
    on a rank of a group, one ``all_gather`` of the rank's flat int64
    row, so every rank sums every worker's bytes and messages and sees
    the same halt, overflow and wrap verdicts (the JAX ``shard_map``
    psums its stats on the device for the same reason). Returns (halt,
    overflow, {key: bytes}, {key: msgs}, {key: ovf})."""
    keys = sorted(nbytes)
    okeys = sorted(novf)
    parts = [halt_all.reshape(1), overflow.reshape(1)]
    parts += [nbytes[k] for k in keys] + [nmsgs[k] for k in keys]
    parts += [novf[k].any().reshape(1) for k in okeys]
    rows = workers.gather_host(
        torch.cat([p.to(torch.int64) for p in parts])).numpy()
    w = nbytes[keys[0]].numel() if keys else 0
    per = rows[:, 2:2 + 2 * len(keys) * w].reshape(
        rows.shape[0], 2, len(keys), w).sum(axis=(0, 3))
    ovf = rows[:, 2 + 2 * len(keys) * w:].any(axis=0)
    return (bool(rows[:, 0].all()), bool(rows[:, 1].any()),
            {k: int(per[0, i]) for i, k in enumerate(keys)},
            {k: int(per[1, i]) for i, k in enumerate(keys)},
            {k: bool(ovf[i]) for i, k in enumerate(okeys)})


def _check_workers(graph: PartitionedGraph, workers):
    """The workers layer of a host loop (None: all of ``graph``'s workers
    in this process), checked against the rows ``graph`` holds."""
    workers = workers_lib.resolve(workers, graph.num_workers)
    if workers.size != graph.num_workers or workers.rows != graph.rows:
        raise ValueError(
            f"a graph of {graph.num_workers} workers holding {graph.rows} "
            f"row(s) under a workers layer of {workers.size} workers and "
            f"{workers.rows} row(s)")
    if workers.distributed and graph.worker != workers.rank:
        raise ValueError(f"rank {workers.rank} holds the rows of worker "
                         f"{graph.worker}")
    return workers


def _gathered(workers, state):
    """Every worker's rows of each state leaf, ``(W, ...)`` on every
    rank (the state itself locally)."""
    if not workers.distributed:
        return state
    return {k: workers.gather(v) for k, v in state.items()}


# the fields of a graph that name it rather than shape it: they never
# enter a step (the JAX package's scrub_graph drops them too), and which
# worker's rows a rank holds
_IDENTITY_FIELDS = frozenset({"name", "new_of_old", "device",
                              "remote_entries", "total_edges",
                              "mirrored_edges", "worker"})


def graph_signature(graph: PartitionedGraph) -> tuple:
    """Hashable static surface of a partitioned graph: every table's shape
    and dtype and every static cap, plan by plan, without the fields that
    only name the graph. Two graphs with equal signatures run the same
    loops; a checkpoint records its hash (``checkpoint.graph_hash``). It
    is the whole partition's: a rank's graph (one worker's rows) gives
    its tables' leading dim as W, so every rank of a group and the local
    backend sign one partition alike."""
    lead = (graph.num_workers,)

    def sig(x):
        if isinstance(x, torch.Tensor):
            return ("tensor", lead + tuple(x.shape[1:]), str(x.dtype))
        if dataclasses.is_dataclass(x):
            return (type(x).__name__,) + tuple(
                (f.name, sig(getattr(x, f.name)))
                for f in dataclasses.fields(x)
                if f.name not in _IDENTITY_FIELDS)
        return x

    return sig(graph)


def _registry(channels) -> Optional[ChannelRegistry]:
    """The registry of a ``channels=`` declaration (names, a composed
    channel such as ``compose.Stacked``, or a mixed sequence), or None
    when nothing is declared."""
    names = compose.channel_names_of(channels) if channels else ()
    return ChannelRegistry.declare(names) if names else None


def _check_declared(registry, touched: set) -> None:
    """A declared channel that no step reached is a stale or misspelled
    declaration."""
    phantom = set(registry.names) - touched
    if phantom:
        raise ValueError(
            f"declared channels {tuple(sorted(phantom))} were never "
            f"reached by the step function (reached: "
            f"{tuple(sorted(touched))}) — stale or misspelled "
            "declaration")


def _call_step(step_fn, ctx, graph, state, step):
    """``(new_state, halt, overflow)`` of one step (overflow False when
    the step returns none)."""
    out = step_fn(ctx, graph, state, step)
    if len(out) == 3:
        return out
    return out[0], out[1], False


def _overflow_error(steps, ovf_by, res):
    bad = sorted(k for k, v in ovf_by.items() if v)
    return errors.ChannelOverflowError(
        errors.overflow_message(steps - 1, bad),
        superstep=steps - 1, channels=bad, result=res)


def run_supersteps(
    graph: PartitionedGraph,
    step_fn: Callable,
    state0: Any,
    max_steps: int = 10_000,
    check_overflow: bool = True,
    mode: str = "host",
    channels: Optional[Any] = None,
    chunk_size: int = 64,
    name: str = "",
    cap_scales: Optional[Dict[str, float]] = None,
    dense_threshold: Optional[float] = None,
    workers: Any = None,
) -> RunResult:
    """Run ``step_fn(ctx, graph, state, step)`` to halt.

    state0: dict of ``(W, n_loc, ...)`` tensors on ``graph.device``.
    step_fn returns ``(new_state, halt)`` or ``(new_state, halt,
    overflow)``; halt/overflow are per-worker ``(W,)`` or scalar. ``step``
    is the superstep number: a Python int in host mode, a device int32
    scalar in the device modes.
    mode: ``"host"``, ``"fused"`` or ``"chunked"`` (see the module
    docstring); ``chunk_size`` is K, the supersteps a dispatch of the
    device modes covers. ``name`` names the program in capture errors.
    channels: optional declaration of the stat keys (names, a composed
    channel such as ``compose.Stacked``, or a mixed sequence); every key
    then appears in the result, an undeclared key raises, and a declared
    key that no step reached raises.
    cap_scales: channel-capacity scales (``ChannelContext.cap_scales``:
    a channel's full name or the ``"*"`` wildcard to a factor).
    dense_threshold: the density-switch threshold the run is held under
    (None: :func:`resolve_knobs`).
    workers: the cross-worker layer (``repro_torch.distributed.workers``):
    None for all W workers in this process; a ``GroupWorkers`` runs one
    worker a rank of its group (in every mode; the device modes
    uncaptured), ``graph`` holding that worker's rows, and returns every
    worker's state ``(W, ...)`` on every rank.

    A device mode builds its loop for this one call (warm-up and capture
    are ``compile_time_s``); hold an ``Engine`` to replay it across runs.
    """
    if mode not in MODES:
        raise ValueError(f"unknown execution mode {mode!r}")
    if mode != "host":
        loop = DeviceLoop(graph, step_fn, state0, mode=mode,
                          max_steps=max_steps, check_overflow=check_overflow,
                          chunk_size=chunk_size, channels=channels,
                          name=name, cap_scales=cap_scales,
                          dense_threshold=dense_threshold, workers=workers)
        try:
            res = loop.execute(state0)
        finally:
            loop.release()
        res.compile_time_s = loop.compile_time_s
        return res
    registry = _registry(channels)
    workers = _check_workers(graph, workers)
    W, n_loc = graph.num_workers, graph.n_loc
    bytes_acc: Dict[str, int] = {}
    msgs_acc: Dict[str, int] = {}
    ovf_acc: Dict[str, bool] = {}
    touched: set = set()
    state = state0
    halted = overflowed = False
    wrapped: set = set()
    step_times = []
    overhead = 0.0
    t0 = time.perf_counter()
    knobs = resolve_knobs(None, dense_threshold)
    with knob_scope(knobs):
        step = -1  # so max_steps=0 reports zero executed supersteps
        for step in range(max_steps):
            ts = time.perf_counter()
            ctx = ChannelContext(W, n_loc, graph.device, registry=registry,
                                 route_cap=graph.route_cap,
                                 cap_scales=dict(cap_scales or {}),
                                 workers=workers)
            state, halt, overflow = _call_step(step_fn, ctx, graph, state,
                                               step)
            touched |= ctx.touched
            halt_all = aggregator.all_halted(ctx, halt)
            overflow_any = on_device(overflow, graph.device, torch.bool).any()
            nbytes, nmsgs = ctx.stats()
            t_enq = time.perf_counter()
            halt_now, ovf_now, db, dm, dovf = _readback(
                workers, halt_all, overflow_any, nbytes, nmsgs,
                ctx.stats_ovf)
            t_dev = time.perf_counter()
            for acc, delta in ((bytes_acc, db), (msgs_acc, dm)):
                for k, d in delta.items():
                    if d < 0:
                        wrapped.add(k)
                    acc[k] = acc.get(k, 0) + d
            for k, v in dovf.items():
                ovf_acc[k] = ovf_acc.get(k, False) or v
            step_times.append(t_dev - ts)
            overhead += (t_enq - ts) + (time.perf_counter() - t_dev)
            if check_overflow and ovf_now:
                overflowed = True
                break
            if wrapped:
                break
            if halt_now:
                halted = True
                break
    if registry is not None and step >= 0:
        _check_declared(registry, touched)
    res = RunResult(
        state=_gathered(workers, state),
        steps=step + 1,
        halted=halted,
        bytes_by_channel=bytes_acc,
        msgs_by_channel=msgs_acc,
        wall_time_s=time.perf_counter() - t0,
        step_times_s=step_times,
        mode="host",
        dispatches=step + 1,
        host_overhead_s=overhead,
        converged=halted,
        overflow_by_channel=ovf_acc,
    )
    _stamp_knobs(res, knobs)
    if overflowed:
        raise _overflow_error(step + 1, ovf_acc, res)
    if wrapped:
        bad = sorted(wrapped)
        raise errors.TrafficWrapError(
            f"int32 traffic counter wrapped in channel(s) {', '.join(bad)} "
            f"at superstep {step} — per-step traffic exceeds int32 range",
            superstep=step, channels=bad, result=res)
    return res


# ---------------------------------------------------------------------------
# the device modes: K supersteps captured into one CUDA graph, each under
# a device-side condition, replayed once a dispatch
# ---------------------------------------------------------------------------


class _HostSyncGuard(TorchDispatchMode):
    """Raises on the operators that read a device value back to the host
    (``.item()``, ``bool()``, ``nonzero``, boolean-mask indexing, ...):
    a stream that captures a CUDA graph refuses them. The device loop
    runs its warm-up step and every captured (or, on the CPU, executed)
    step under it, so such a step fails before a capture starts, with
    the program named, and the CPU tests hold the step code to the
    capture's contract. An eager inner loop reads its condition with
    :meth:`read`, which the guard lets through."""

    SYNCS = frozenset({
        "aten::_local_scalar_dense", "aten::nonzero", "aten::masked_select",
        "aten::unique_dim", "aten::_unique", "aten::_unique2",
        "aten::unique_consecutive", "aten::unique_dim_consecutive",
        "aten::bincount"})

    def __init__(self, what: str):
        super().__init__()
        self.what = what
        self.reading = False

    def read(self, flag: torch.Tensor) -> bool:
        """``bool(flag)``, let through the guard."""
        self.reading = True
        try:
            return bool(flag)
        finally:
            self.reading = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.reading:
            return func(*args, **kwargs)
        op = func._schema.name
        sync = op in self.SYNCS
        if op in ("aten::index", "aten::index_put_", "aten::index_put"):
            sync = any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                       for i in (args[1] or ()) if i is not None)
        elif op == "aten::repeat_interleave":
            sync = kwargs.get("output_size") is None
        if sync:
            raise RuntimeError(
                f"{self.what}: {op} reads a device value back to the host, "
                "which a stream that captures a CUDA graph refuses "
                "(operation not permitted when stream is capturing)")
        return func(*args, **kwargs)


_tokens = itertools.count()


class DeviceLoop:
    """The ``fused`` or ``chunked`` superstep loop of one step function on
    one graph: static state buffers, the loop's flags and stats, and on
    the card the captured K-step CUDA graph. Built once (warm-up step and
    capture: ``compile_time_s``), then :meth:`execute` runs it from any
    ``state0`` of the same shapes; ``Engine`` caches it per program,
    graph object, mode, K, ``max_steps`` and ``check_overflow``.

    Buffers: ``out`` holds int32 flags ``[i, halted, overflow, wrapped]``,
    then (:class:`BatchedDeviceLoop`) four ``(Q,)`` lane rows, and then,
    chunked, K stat rows or, fused, one accumulator row; a row is each
    stat key's ``(W,)`` (batched ``(W, Q)``) bytes, then their messages,
    then each overflow key's flag (batched one a lane). On a rank of a
    group (``workers``) a row holds the rank's one worker, and
    :meth:`_read` merges every rank's words into the ``W``-worker layout.
    ``go`` is the bool the IF nodes read. The steps' contexts carry the
    loop's :class:`DeviceLoopHooks`: eager ones for the warm-up (and
    every step on the CPU and on a group), ones with the capture's
    conditional-node streams while the card captures."""

    #: the query lanes of a batched loop (None: a solo loop)
    q: Optional[int] = None
    #: the serving substrate: per-lane ages in place of the step counter
    serve = False

    def __init__(self, graph: PartitionedGraph, step_fn: Callable,
                 state0: Dict[str, torch.Tensor], *, mode: str,
                 max_steps: int, check_overflow: bool = True,
                 chunk_size: int = 64, channels: Optional[Any] = None,
                 name: str = "", cap_scales: Optional[Dict] = None,
                 route_batch: Optional[str] = None,
                 dense_threshold: Optional[float] = None,
                 workers: Any = None):
        if mode not in ("fused", "chunked"):
            raise ValueError(f"a device loop runs mode 'fused' or "
                             f"'chunked', not {mode!r}")
        if not isinstance(state0, dict):
            raise TypeError("the device modes take a dict of tensors as "
                            f"the state, got {type(state0).__name__}")
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be at least 1, got "
                             f"{chunk_size}")
        self.graph, self.step_fn, self.mode = graph, step_fn, mode
        self.name = name or getattr(step_fn, "__qualname__", "step")
        self.max_steps, self.check_overflow = int(max_steps), check_overflow
        # a serving lane's budget is its own age: a chunk is never cut
        self.K = max(1, int(chunk_size) if self.serve
                     else min(int(chunk_size), self.max_steps))
        self.registry = _registry(channels)
        # the capacity scales enter each step's context, so the captured
        # graph is sized by them (a loop per scale set)
        self.cap_scales = dict(cap_scales or {})
        # the data-plane knobs, frozen into the capture and pinned for
        # every step the host runs (module docstring)
        self.knobs = resolve_knobs(route_batch, dense_threshold)
        self.device = graph.device
        self.cuda = self.device.type == "cuda"
        self.workers = _check_workers(graph, workers)
        # a group's ranks run the loop eagerly: a gloo collective cannot
        # be captured into a CUDA graph (module docstring)
        self.capture = self.cuda and not self.workers.distributed
        self.token = next(_tokens)
        self.cuda_graph = self.nest = None
        self.stream = torch.cuda.Stream(self.device) if self.capture else None
        self.guard = _HostSyncGuard(self.name)
        self.hooks = DeviceLoopHooks(read=self.guard.read)
        t = time.perf_counter()
        # the warm-up step's and the capture's wrapper calls are no
        # superstep of a run: the counts go back to what they were
        before = kops.wrapper_launch_counts()
        try:
            with knob_scope(self.knobs):
                self._warm_up(state0)
                self._allocate(state0)
                if self.capture:
                    self._capture()
        except BaseException:
            self.release()
            raise
        finally:
            kops.set_wrapper_launch_counts(before)
        self.compile_time_s = time.perf_counter() - t

    # -- build --------------------------------------------------------------

    def _context(self, live: Optional[torch.Tensor] = None
                 ) -> ChannelContext:
        return ChannelContext(self.graph.num_workers, self.graph.n_loc,
                              self.device, registry=self.registry,
                              route_cap=self.graph.route_cap,
                              num_queries=self.q, query_live=live,
                              device_loop=self.hooks,
                              cap_scales=self.cap_scales,
                              workers=self.workers)

    @contextlib.contextmanager
    def _on_side_stream(self):
        """The scratch scope, and on a card that captures the loop's own
        stream."""
        if not self.capture:
            with scratch.scope(self.token):
                yield
            return
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream), scratch.scope(self.token):
            yield
        main.wait_stream(self.stream)

    def _warm_up(self, state0) -> None:
        """One eager step on a clone of ``state0``, its result dropped: it
        builds the kernels, sizes their scratch under the loop's scope and
        fixes the stat keys and the state's layout."""
        state = {k: v.clone() for k, v in state0.items()}
        dev = self.device
        with self._on_side_stream(), self.guard:
            live = (None if self.q is None
                    else torch.ones(self.q, dtype=torch.bool, device=dev))
            ctx = self._context(live)
            i = torch.zeros((self.q,) if self.serve else (),
                            dtype=torch.int32, device=dev)
            new_state, halt, ovf = _call_step(self.step_fn, ctx, self.graph,
                                              state, i)
            aggregator.all_halted(ctx, halt)
            on_device(ovf, self.device, torch.bool).any()
        if self.cuda:
            torch.cuda.synchronize(self.device)
        if self.registry is not None:
            _check_declared(self.registry, ctx.touched)
        self.bkeys = sorted(ctx.stats_bytes)
        self.okeys = sorted(ctx.stats_ovf)
        layout = {k: (v.shape, v.dtype) for k, v in state0.items()}
        if {k: (v.shape, v.dtype) for k, v in new_state.items()} != layout:
            raise ValueError(
                f"{self.name}: a superstep changes the state's keys, shapes "
                "or dtypes; the device modes need a fixed layout")

    def _allocate(self, state0) -> None:
        w, dev, lanes = self.workers.rows, self.device, self.q or 1
        # a row's traffic columns and length here, and in the W-worker
        # layout that _read returns (the same locally)
        self.nb = 2 * len(self.bkeys) * w * lanes
        self.row_len = self.nb + len(self.okeys) * lanes
        self.host_nb = 2 * len(self.bkeys) * self.graph.num_workers * lanes
        self.host_row_len = self.host_nb + len(self.okeys) * lanes
        rows = self.K if self.mode == "chunked" else 1
        self.state = {k: torch.empty_like(
            v, memory_format=torch.contiguous_format)
            for k, v in state0.items()}
        # the flags, then a batched loop's (Q,) halted, overflow, age and
        # steps rows
        self.head = 4 + (0 if self.q is None else 4 * self.q)
        self.out = torch.zeros(self.head + rows * self.row_len,
                               dtype=torch.int32, device=dev)
        self.flags = self.out[:4]
        self.lanes = self.out[4:self.head].view(-1, lanes)
        self.rows = self.out[self.head:].view(rows, self.row_len)
        self.go = torch.zeros((), dtype=torch.bool, device=dev)
        self.host = torch.empty(self.out.shape, dtype=torch.int32,
                                pin_memory=self.cuda)

    def _capture(self) -> None:
        """The K supersteps into one CUDA graph on the loop's stream, each
        the body of an IF node on ``go`` and each inner loop a WHILE node
        inside it (``kernels.graph_if``), every body captured on a stream
        of its depth whose allocations have a pool of their own. Every
        captured superstep must make the same kernel launches."""
        g = torch.cuda.CUDAGraph()
        self.nest = graph_if.Nest(self.device)
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        try:
            with scratch.scope(self.token), \
                    torch.cuda.graph(g, stream=self.stream):
                eager = self.hooks
                self.hooks = DeviceLoopHooks(self.guard.read, self.nest)
                try:
                    per_step = self._chunk()
                finally:
                    self.hooks = eager
                    self.nest.close()
        except Exception as err:
            err.add_note(f"while capturing the {self.mode} superstep loop "
                         f"of {self.name}")
            raise
        self.cuda_graph = g
        if any(n != per_step[0] for n in per_step):
            raise RuntimeError(
                f"{self.name}: the {self.K} captured supersteps made "
                f"{per_step} kernel launches — a superstep's launches must "
                "not change from one superstep to the next")

    def release(self) -> None:
        """Drop the captured graph, its memory pools and its scratch."""
        self.cuda_graph = None
        if self.nest is not None:
            self.nest.release()
            self.nest = None
        scratch.release(self.token)

    # -- one chunk of K supersteps -------------------------------------------

    def _chunk(self) -> list:
        """The K supersteps, each when ``go``; returns each one's wrapper
        calls of each kernel (what a captured superstep launches when it
        runs)."""
        if self.mode == "chunked":
            self.rows.zero_()  # a step that does not run leaves zeros
        per_step = []
        for k in range(self.K):
            before = kops.wrapper_launch_counts()
            self._when_go(lambda: self._step(k))
            after = kops.wrapper_launch_counts()
            per_step.append({n: after[n] - before[n] for n in after})
        return per_step

    def _when_go(self, fn) -> None:
        if self.hooks.nest is not None:  # capturing: into an IF node's body
            with self.nest.if_node(self.go), self.guard:
                fn()
        elif bool(self.go):
            with self.guard:
                fn()

    def _group_verdict(self, halt: torch.Tensor, ovf: torch.Tensor):
        """The group's halt (every rank) and overflow (any rank) votes,
        one ``all_gather`` of both: ``go`` and the lane rows follow them,
        so every rank takes the same branch. Locally the votes as they
        are."""
        if not self.workers.distributed:
            return halt, ovf
        both = self.workers.gather(torch.stack([halt, ovf])[None])
        return both[:, 0].all(dim=0), both[:, 1].any(dim=0)

    def _step(self, k: int) -> None:
        """Superstep ``i`` into the static buffers: the state, the flags,
        ``go`` and the stats (row ``k``, or the accumulator)."""
        ctx = self._context()
        i = self.flags[0]
        new_state, halt, ovf = _call_step(self.step_fn, ctx, self.graph,
                                          self.state, i)
        halt_all, ovf_any = self._group_verdict(
            aggregator.all_halted(ctx, halt),
            on_device(ovf, self.device, torch.bool).any())
        row = self._row(ctx)
        self._store(new_state)
        self._record(k, row)
        self.flags[0].add_(1)
        self.flags[1].copy_(halt_all)
        self.flags[2].copy_(self.flags[2] | ovf_any)
        go = (self.flags[1] == 0) & (self.flags[0] < self.max_steps)
        if self.check_overflow:
            go = go & (self.flags[2] == 0)
        self.go.copy_(go)

    def _row(self, ctx: ChannelContext,
             live: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The step's stat row; batched, only the ``live`` lanes' stats
        (a lane that does not run adds no traffic and no overflow)."""
        extra = (set(ctx.stats_bytes) - set(self.bkeys)) | (
            set(ctx.stats_ovf) - set(self.okeys))
        if extra:
            raise ValueError(
                f"{self.name}: stat keys {sorted(extra)} appeared after the "
                "first superstep; the device modes need a fixed key set")
        zeros = torch.zeros(ctx.stat_shape, dtype=torch.int32,
                            device=self.device)
        parts = [ctx.stats_bytes.get(k, zeros) for k in self.bkeys]
        parts += [ctx.stats_msgs.get(k, zeros) for k in self.bkeys]
        ovf = [ctx.stats_ovf.get(k, zeros.bool()) for k in self.okeys]
        if live is not None:
            parts = [torch.where(live, p, 0) for p in parts]
            ovf = [v & live for v in ovf]
        parts += [v.reshape(ctx.rows, -1).any(dim=0) for v in ovf]
        if not parts:  # a step with no channel
            return zeros.reshape(-1)[:0]
        return torch.cat([p.reshape(-1).to(torch.int32) for p in parts])

    def _record(self, k: int, row: torch.Tensor) -> None:
        """Step ``k``'s stat row into its chunk row, or into the fused
        accumulator with the wrap latch."""
        if self.mode == "chunked":
            self.rows[k].copy_(row)
            return
        acc = self.rows[0]
        new = acc[:self.nb] + row[:self.nb]
        # the deltas are not negative: an accumulator that decreases
        # wrapped
        self.flags[3].copy_(self.flags[3] | (new < acc[:self.nb]).any())
        acc[:self.nb].copy_(new)
        acc[self.nb:].copy_(acc[self.nb:] | row[self.nb:])

    def _store(self, new_state) -> None:
        """``new_state`` into the static buffers (``core.channel.store``)."""
        store([self.state[k] for k in new_state], new_state.values())

    # -- a run ---------------------------------------------------------------

    def _read(self, n: int) -> np.ndarray:
        """The first ``n`` words of ``out`` on the host, in one copy; on a
        group every rank's, merged (:meth:`_merged`)."""
        if self.workers.distributed:
            return self._merged(self.workers.gather_host(
                self.out[:n]).numpy().astype(np.int64))
        dst = self.host[:n]
        dst.copy_(self.out[:n], non_blocking=self.cuda)
        if self.cuda:
            torch.cuda.current_stream(self.device).synchronize()
        return dst.numpy().astype(np.int64)

    def _merged(self, words: np.ndarray) -> np.ndarray:
        """Every rank's first words of ``out`` (``(R, n)``, rank order) as
        one process's words over all W workers: the flags and lane rows,
        which the voted ``go`` keeps equal on every rank (checked), with
        the fused wrap latch ORed; each stat row's per-key blocks of one
        worker laid side by side in rank order, the overflow flags
        ORed."""
        head = min(words.shape[1], self.head)
        differ = (words[:, :head] != words[0, :head]).any(axis=0)
        differ[3] = False  # the fused wrap latch is each rank's own
        if differ.any():
            raise RuntimeError(
                f"{self.name}: the group's ranks disagree on the loop's "
                f"flags or lane rows: {words[:, :head].tolist()}")
        out = words[0, :head].copy()
        out[3] = words[:, 3].max()
        if words.shape[1] <= self.head:
            return out
        r, lanes = words.shape[0], self.q or 1
        rows = words[:, self.head:].reshape(r, -1, self.row_len)
        cols = 2 * len(self.bkeys)
        traffic = rows[:, :, :self.nb].reshape(r, -1, cols, lanes)
        traffic = traffic.transpose(1, 2, 0, 3).reshape(rows.shape[1], -1)
        ovf = rows[:, :, self.nb:].any(axis=0).astype(np.int64)
        return np.concatenate(
            [out, np.concatenate([traffic, ovf], axis=1).reshape(-1)])

    def _dispatch(self) -> None:
        """One chunk: a replay of the captured graph, or (on the CPU, on
        a group) the K steps run eagerly under their ``go``."""
        if self.cuda_graph is not None:
            self.cuda_graph.replay()
        else:
            with scratch.scope(self.token):
                self._chunk()

    def gathered(self, state: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """Every worker's rows of ``state`` (this rank's rows of each
        leaf), ``(W, ...)``: the state itself locally, a collective of the
        group on a rank."""
        return _gathered(self.workers, state)

    @contextlib.contextmanager
    def replays_counted(self):
        """On the card, the kernel launches of the replays inside the
        ``with``, as the kernels count them on the device, go to
        ``ops.launch_counts`` (a replay launches its kernels without the
        wrappers, an inner loop as often as its condition says). Reading
        the counters synchronizes the device."""
        launched = (kops.device_launch_counts()
                    if self.cuda_graph is not None else None)
        try:
            yield
        finally:
            if launched is not None:
                now = kops.device_launch_counts()
                kops.add_replayed({k: now[k] - launched[k] for k in now})

    def load(self, state0: Dict[str, torch.Tensor]) -> None:
        """``state0`` into the loop's state buffers."""
        if {k: (v.shape, v.dtype) for k, v in state0.items()} != {
                k: (v.shape, v.dtype) for k, v in self.state.items()}:
            raise ValueError(f"{self.name}: state0 does not match the "
                             "layout this loop was built for")
        for k, v in state0.items():
            self.state[k].copy_(v)

    def execute(self, state0: Dict[str, torch.Tensor], *,
                checkpoint_every: Optional[int] = None,
                checkpoint_cb: Optional[Callable] = None,
                resume: Optional[dict] = None) -> RunResult:
        """Run the loop from ``state0`` to a halt, ``max_steps`` or an
        overflow; the result's state is a copy, so a later run does not
        overwrite it. On the card the replays' kernel launches go to
        ``ops.launch_counts`` (:meth:`replays_counted`).

        Chunked only (``repro_torch.pregel.checkpoint``): at the first
        chunk boundary at or past every ``checkpoint_every`` supersteps,
        ``checkpoint_cb`` gets the carry (step, state as host numpy, the
        traffic and overflow so far, dispatches); ``resume`` (such a
        carry) writes the step into the loop's counter, the state into its
        buffers and seeds the host's int64 accumulators, so the replays
        go on from that boundary bit for bit, with no new capture."""
        if (checkpoint_every is not None or checkpoint_cb is not None
                or resume is not None) and self.mode != "chunked":
            raise ValueError(
                "checkpoint/resume needs the unbatched chunked substrate — "
                f"this loop is mode={self.mode!r}. Build it with "
                "mode='chunked' (Engine(mode='chunked')) to checkpoint at "
                "dispatch boundaries.")
        with self.replays_counted(), knob_scope(self.knobs):
            res = self._execute(state0, checkpoint_every, checkpoint_cb,
                                resume)
        return _stamp_knobs(res, self.knobs)

    def _execute(self, state0, checkpoint_every=None, checkpoint_cb=None,
                 resume=None) -> RunResult:
        t0 = time.perf_counter()
        bytes_acc = dict.fromkeys(self.bkeys, 0)
        msgs_acc = dict.fromkeys(self.bkeys, 0)
        ovf_acc = dict.fromkeys(self.okeys, False)
        start = 0
        if resume is not None:
            start = int(resume["step"])
            # every worker's state: a rank takes its own rows
            state0 = {k: self.graph.mine(torch.as_tensor(v)).to(self.device)
                      for k, v in resume["state"].items()}
            bytes_acc.update(resume["bytes_by_channel"])
            msgs_acc.update(resume["msgs_by_channel"])
            ovf_acc.update(resume.get("overflow_by_channel", {}))
        self.load(state0)
        self.out.zero_()
        # the captured steps read the counter from the buffer, never a
        # Python int frozen at capture, so a resume is a fill
        self.flags[0].fill_(start)
        self.go.fill_(start < self.max_steps)
        next_due = start + checkpoint_every if checkpoint_every else None
        chunked = self.mode == "chunked"
        w = self.graph.num_workers
        wrapped: set = set()
        times, dispatches, overhead = [], 0, 0.0
        n_read = self.out.numel() if chunked else 4
        while True:
            ts = time.perf_counter()
            self._dispatch()
            dispatches += 1
            t_enq = time.perf_counter()
            host = self._read(n_read)
            t_dev = time.perf_counter()
            steps, halted, overflow = (int(x) for x in host[:3])
            if chunked:  # the chunk's per-step rows, summed in int64
                rows = host[4:].reshape(self.K, self.host_row_len)
                for j, key in enumerate(self.bkeys):
                    for acc, col in ((bytes_acc, j), (msgs_acc,
                                                      len(self.bkeys) + j)):
                        block = rows[:, col * w:(col + 1) * w]
                        if (block < 0).any():
                            wrapped.add(key)
                        acc[key] += int(block.sum())
                for j, key in enumerate(self.okeys):
                    ovf_acc[key] |= bool(rows[:, self.host_nb + j].any())
            times.append(time.perf_counter() - ts)
            overhead += (t_enq - ts) + (time.perf_counter() - t_dev)
            overflowed = self.check_overflow and bool(overflow)
            if overflowed or wrapped or halted or steps >= self.max_steps:
                break
            if checkpoint_cb is not None and next_due is not None \
                    and steps >= next_due:
                checkpoint_cb({
                    "step": steps,
                    "state": {k: v.cpu().numpy().copy() for k, v
                              in self.gathered(self.state).items()},
                    "bytes_by_channel": dict(bytes_acc),
                    "msgs_by_channel": dict(msgs_acc),
                    "overflow_by_channel": dict(ovf_acc),
                    "dispatches": dispatches,
                })
                next_due = steps + checkpoint_every
        latch = False
        if not chunked:  # the totals, once
            t_r = time.perf_counter()
            acc = self._read(self.out.numel())
            latch = bool(acc[3])
            row = acc[4:]
            for j, key in enumerate(self.bkeys):
                bytes_acc[key] = int(row[j * w:(j + 1) * w].sum())
                m = len(self.bkeys) + j
                msgs_acc[key] = int(row[m * w:(m + 1) * w].sum())
            for j, key in enumerate(self.okeys):
                ovf_acc[key] = bool(row[self.host_nb + j])
            overhead += time.perf_counter() - t_r
        state = {k: v.clone() for k, v in self.gathered(self.state).items()}
        res = RunResult(
            state=state, steps=steps, halted=bool(halted),
            bytes_by_channel=bytes_acc, msgs_by_channel=msgs_acc,
            wall_time_s=time.perf_counter() - t0, step_times_s=times,
            mode=self.mode, dispatches=dispatches, host_overhead_s=overhead,
            converged=bool(halted), overflow_by_channel=ovf_acc,
            resumed_from=start, captured=self.cuda_graph is not None)
        if overflowed:
            raise _overflow_error(steps, ovf_acc, res)
        if wrapped:
            bad = sorted(wrapped)
            raise errors.TrafficWrapError(
                f"int32 traffic counter wrapped in channel(s) "
                f"{', '.join(bad)} by superstep {steps - 1} — per-step "
                "traffic exceeds int32 range",
                superstep=steps - 1, channels=bad, result=res)
        if latch:
            # the fused latch is global (an accumulator decreased): no
            # per-channel attribution on the device
            raise errors.TrafficWrapError(
                "per-channel traffic counters overflowed int32 inside the "
                "fused loop; bytes/msgs totals are unreliable — use "
                "mode='chunked' (exact host-side int64 accumulation) for "
                "runs this heavy", superstep=steps - 1, result=res)
        return res


# ---------------------------------------------------------------------------
# batched query plane: one loop advances Q query instances per superstep,
# with per-query halt voting, frozen state for halted queries, and
# per-query step/traffic attribution (Engine.run_batch rides this)
# ---------------------------------------------------------------------------


def _qmask(live: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Broadcast a (Q,) liveness mask against a (W, Q, ...) state leaf."""
    return live.reshape((1,) + live.shape + (1,) * (leaf.dim() - 2))


def _readback_lanes(workers, halted, overflow, nbytes, nmsgs, novf):
    """One device-to-host copy of everything the batched loop reads per
    step: the (Q,) halt and overflow flags, the (W, Q) per-lane stats
    (summed over W on the host in int64) and the per-channel overflow
    latches — on a rank of a group one ``all_gather`` of the rank's row,
    the halt flags ANDed and the rest ORed and summed over the ranks, as
    :func:`_readback`. Returns (halted, overflow, {key: bytes (Q,)},
    {key: msgs (Q,)}, {key: ovf (Q,)}) as numpy."""
    q = halted.numel()
    keys, okeys = sorted(nbytes), sorted(novf)
    parts = [halted, overflow] + [nbytes[k] for k in keys]
    parts += [nmsgs[k] for k in keys] + [novf[k].any(dim=0) for k in okeys]
    rows = workers.gather_host(
        torch.cat([p.reshape(-1).to(torch.int64) for p in parts])).numpy()
    off = 2 * q + 2 * sum(nbytes[k].numel() for k in keys)
    w = nbytes[keys[0]].shape[0] if keys else 0
    n = rows.shape[0]
    per = rows[:, 2 * q:off].reshape(n, 2, len(keys), w, q).sum(axis=(0, 3))
    ovf = rows[:, off:].reshape(n, len(okeys), q).any(axis=0)
    return (rows[:, :q].all(axis=0), rows[:, q:2 * q].any(axis=0),
            {k: per[0, i] for i, k in enumerate(keys)},
            {k: per[1, i] for i, k in enumerate(keys)},
            {k: ovf[i] for i, k in enumerate(okeys)})


def _batched_result(state, steps, halted_q, overflow_q, q_bytes, q_msgs,
                    steps_q, q_real, *, mode, dispatches, wall, step_times,
                    overhead, check_overflow, ovf_by, wrapped,
                    latch=False, captured=False) -> RunResult:
    """The batched run's result over its ``q_real`` real lanes; raises
    its overflow (with the lanes' qids) or wrap error. ``wrapped`` names
    the channels whose per-step count went negative (host and chunked
    modes); ``latch`` is the fused loop's global wrap latch."""
    # report only the real leading lanes: the pad lanes (which start
    # halted) surface only in the all-zero pad audit
    pad = slice(q_real, None)
    res = RunResult(
        state=state,
        steps=steps,
        halted=bool(halted_q[:q_real].all()),
        bytes_by_channel={k: int(v[:q_real].sum())
                          for k, v in q_bytes.items()},
        msgs_by_channel={k: int(v[:q_real].sum()) for k, v in q_msgs.items()},
        wall_time_s=wall,
        step_times_s=step_times,
        mode=mode,
        dispatches=dispatches,
        host_overhead_s=overhead,
        converged=bool(halted_q[:q_real].all()),
        overflow_by_channel={k: v[:q_real] for k, v in ovf_by.items()},
        num_queries=q_real,
        query_steps=steps_q[:q_real],
        query_halted=halted_q[:q_real],
        query_bytes_by_channel={k: v[:q_real] for k, v in q_bytes.items()},
        query_msgs_by_channel={k: v[:q_real] for k, v in q_msgs.items()},
        num_pad_lanes=len(steps_q) - q_real,
        pad_steps=int(steps_q[pad].sum()),
        pad_bytes=int(sum(v[pad].sum() for v in q_bytes.values())),
        pad_msgs=int(sum(v[pad].sum() for v in q_msgs.values())),
        captured=captured,
    )
    if check_overflow and overflow_q[:q_real].any():
        qs = np.flatnonzero(overflow_q[:q_real]).tolist()
        bad = sorted(k for k, v in res.overflow_by_channel.items()
                     if v.any())
        raise errors.ChannelOverflowError(
            errors.overflow_message(steps - 1, bad, qids=qs),
            superstep=steps - 1, channels=bad, result=res, qids=qs)
    if wrapped:
        bad = sorted(wrapped)
        raise errors.TrafficWrapError(
            f"int32 traffic counter wrapped in channel(s) {', '.join(bad)} "
            f"at superstep {steps - 1} — per-step traffic exceeds int32 "
            "range", superstep=steps - 1, channels=bad, result=res)
    if latch:
        raise errors.TrafficWrapError(
            "per-channel traffic counters overflowed int32 inside the "
            "batched loop; bytes/msgs totals are unreliable — use "
            "mode='chunked' (exact host-side int64 accumulation) for "
            "runs this heavy", superstep=steps - 1, result=res)
    return res


def run_batched_supersteps(
    graph: PartitionedGraph,
    step_fn: Callable,
    state0: Dict[str, torch.Tensor],
    num_real_queries: int,
    max_steps: int = 10_000,
    check_overflow: bool = True,
    channels: Optional[Any] = None,
    cap_scales: Optional[Dict[str, float]] = None,
    route_batch: Optional[str] = None,
    dense_threshold: Optional[float] = None,
    workers: Any = None,
) -> RunResult:
    """Run Q query lanes of ``step_fn`` to halt in one host-driven loop.

    state0: dict of ``(W, Q, n_loc, ...)`` tensors on ``graph.device``;
    lanes ``num_real_queries`` and up are padding and start halted. The
    step sees a batched ``ChannelContext`` (``num_queries=Q``) and
    returns ``(new_state, halt[, overflow])`` with ``(W, Q)`` (or scalar)
    votes. Returns a RunResult with the per-query views of the real lanes.
    ``dense_threshold`` and ``workers`` as in :func:`run_supersteps`;
    ``route_batch`` says how the routed channels share the lanes' route
    passes.
    """
    workers = _check_workers(graph, workers)
    knobs = resolve_knobs(route_batch, dense_threshold)
    with knob_scope(knobs):
        res = _host_batched(graph, step_fn, state0, num_real_queries,
                            max_steps, check_overflow, channels, cap_scales,
                            workers)
    return _stamp_knobs(res, knobs, batched=True)


def _host_batched(graph, step_fn, state0, num_real_queries, max_steps,
                  check_overflow, channels, cap_scales, workers) -> RunResult:
    registry = _registry(channels)
    W, n_loc, dev = graph.num_workers, graph.n_loc, graph.device
    q = next(iter(state0.values())).shape[1]
    q_real = num_real_queries
    halted = torch.arange(q, device=dev) >= q_real
    halted_np = np.arange(q) >= q_real
    overflow_np = np.zeros(q, bool)
    steps_q = np.zeros(q, np.int64)
    q_bytes: Dict[str, np.ndarray] = {}
    q_msgs: Dict[str, np.ndarray] = {}
    q_ovf: Dict[str, np.ndarray] = {}
    wrapped: set = set()
    touched: set = set()
    step_times = []
    overhead = 0.0
    state = state0
    steps = 0
    t0 = time.perf_counter()
    for step in range(max_steps):
        live_np = ~halted_np
        if not live_np.any():
            break
        ts = time.perf_counter()
        live = ~halted
        ctx = ChannelContext(W, n_loc, dev, registry=registry,
                             route_cap=graph.route_cap, num_queries=q,
                             query_live=live,
                             cap_scales=dict(cap_scales or {}),
                             workers=workers)
        new_state, halt, overflow = _call_step(step_fn, ctx, graph, state,
                                               step)
        touched |= ctx.touched
        state = {k: torch.where(_qmask(live, v), v, state[k])
                 for k, v in new_state.items()}
        halted = halted | aggregator.all_halted(ctx, halt)
        ovf_q = torch.as_tensor(overflow, device=dev).to(torch.bool).expand(
            workers.rows, q).any(dim=0) & live
        nbytes, nmsgs = ctx.stats()
        nbytes = {k: torch.where(live, v, 0) for k, v in nbytes.items()}
        nmsgs = {k: torch.where(live, v, 0) for k, v in nmsgs.items()}
        novf = {k: v & live for k, v in ctx.stats_ovf.items()}
        t_enq = time.perf_counter()
        halted_np, ovf_now, db, dm, dovf = _readback_lanes(
            workers, halted, ovf_q, nbytes, nmsgs, novf)
        if workers.distributed:  # the group's verdict, every lane
            halted = torch.as_tensor(halted_np, device=dev)
        t_dev = time.perf_counter()
        step_times.append(t_dev - ts)
        steps = step + 1
        steps_q += live_np
        for acc, delta in ((q_bytes, db), (q_msgs, dm)):
            for k, row in delta.items():
                if (row < 0).any():
                    wrapped.add(k)
                acc[k] = acc.get(k, 0) + row
        for k, row in dovf.items():
            q_ovf[k] = q_ovf.get(k, False) | row
        overflow_np |= ovf_now
        overhead += (t_enq - ts) + (time.perf_counter() - t_dev)
        if check_overflow and overflow_np[:q_real].any():
            break
        if wrapped:
            break
    if registry is not None and steps:
        _check_declared(registry, touched)
    return _batched_result(
        _gathered(workers, state), steps, halted_np, overflow_np, q_bytes,
        q_msgs, steps_q, q_real, mode="host", dispatches=steps,
        wall=time.perf_counter() - t0, step_times=step_times,
        overhead=overhead, check_overflow=check_overflow, ovf_by=q_ovf,
        wrapped=wrapped)


class BatchedDeviceLoop(DeviceLoop):
    """The batched query plane's ``fused`` or ``chunked`` loop
    (``Engine.run_batch``) or, with ``serve=True``, the serving substrate
    (``Engine.serve``): :class:`DeviceLoop`'s warm-up, capture, IF and
    WHILE nodes and scratch over state leaves ``(W, Q, n_loc, ...)`` and a
    batched ``ChannelContext``.

    The lane rows of ``out``, ``(Q,)`` int32 each: ``halted``,
    ``overflow``, ``age`` and ``steps``. Each step, as the JAX package's
    batched step: the live mask comes from the ``halted`` row before the
    step, so the union route (``routing.lane_live``) reads the lanes of
    this replay and never a mask made at capture; a lane that is not live
    keeps its state bit for bit and adds no traffic and no overflow; the
    halting step itself still charges.

      - ``serve=False`` (``Engine.run_batch``): the step index is the
        loop's counter, a 0-d int32 as in a solo loop; ``halted`` starts
        as the pad mask, which :meth:`execute` writes before each run (the
        graph is cached per bucket cap, not per real Q); ``steps`` counts
        each lane's supersteps; ``go = any(~halted) & (i < max_steps) &
        ~(check_overflow & any(overflow))``.
      - ``serve=True`` (always chunked, K = ``chunk_size``): a lane is
        live when ``~(halted | age >= max_steps)``, and the step index is
        the ``(Q,)`` ``age`` row, each lane's supersteps since its
        admission (under the JAX package's query ``vmap`` each lane sees
        its own scalar; here a step that reads the index gets the
        ``(Q,)`` tensor — ``reach`` and ``sssp`` do not read it). Only a
        live lane's own vote halts or overflows it; ``age`` and ``steps``
        (this chunk's supersteps a lane) grow by ``live``; ``go =
        any(live) & ~(check_overflow & any(overflow))``, so a chunk does
        no work past its last live step. The host admits and harvests
        lanes between dispatches (:meth:`serve_chunk`)."""

    def __init__(self, graph: PartitionedGraph, step_fn: Callable,
                 state0: Dict[str, torch.Tensor], *, mode: str,
                 max_steps: int, check_overflow: bool = True,
                 chunk_size: int = 64, channels: Optional[Any] = None,
                 name: str = "", serve: bool = False,
                 cap_scales: Optional[Dict] = None, workers: Any = None,
                 **knobs):
        if serve and mode != "chunked":
            raise ValueError(f"the serving substrate is chunked, not "
                             f"{mode!r}")
        self.q = next(iter(state0.values())).shape[1]
        self.serve = serve
        super().__init__(graph, step_fn, state0, mode=mode,
                         max_steps=max_steps, check_overflow=check_overflow,
                         chunk_size=chunk_size, channels=channels, name=name,
                         cap_scales=cap_scales, workers=workers, **knobs)

    def _step(self, k: int) -> None:
        halted, overflow, age, steps = self.lanes
        was = halted != 0
        if self.serve:
            index, live = age, ~(was | (age >= self.max_steps))
        else:
            index, live = self.flags[0], ~was
        ctx = self._context(live)
        new_state, halt, ovf = _call_step(self.step_fn, ctx, self.graph,
                                          self.state, index)
        halt_q, ovf_q = self._group_verdict(
            aggregator.all_halted(ctx, halt),
            on_device(ovf, self.device, torch.bool).expand(
                ctx.rows, self.q).any(dim=0))
        if self.serve:  # a dead lane's computation is thrown away
            halt_q = halt_q & live
        ovf_q = ovf_q & live
        row = self._row(ctx, live)
        self._store({key: torch.where(_qmask(live, v), v, self.state[key])
                     for key, v in new_state.items()})
        self._record(k, row)
        now_halted = was | halt_q
        halted.copy_(now_halted)
        overflow.copy_((overflow != 0) | ovf_q)
        steps.add_(live.to(torch.int32))
        self.flags[0].add_(1)
        if self.serve:
            age.add_(live.to(torch.int32))
            dead = now_halted | (age >= self.max_steps)
        else:
            dead = now_halted
        self.flags[1].copy_(dead.all())
        self.flags[2].copy_((overflow != 0).any())
        go = ~self.flags[1].bool()
        if not self.serve:
            go = go & (self.flags[0] < self.max_steps)
        if self.check_overflow:
            go = go & (self.flags[2] == 0)
        self.go.copy_(go)

    def _add_rows(self, rows: np.ndarray, q_bytes, q_msgs, q_ovf,
                  wrapped: Optional[set] = None) -> None:
        """Add ``rows`` (n, row_len) into the per-lane totals: each key's
        ``(W, Q)`` block summed over W in int64, row by row; a negative
        row total names its channel in ``wrapped`` (when given)."""
        n, w, q = rows.shape[0], self.graph.num_workers, self.q
        wq, nk = w * q, len(self.bkeys)
        for j, key in enumerate(self.bkeys):
            for acc, col in ((q_bytes, j), (q_msgs, nk + j)):
                per = rows[:, col * wq:(col + 1) * wq].reshape(n, w, q).sum(
                    axis=1)
                if wrapped is not None and (per < 0).any():
                    wrapped.add(key)
                acc[key] += per.sum(axis=0)
        for j, key in enumerate(self.okeys):
            col = self.host_nb + j * q
            q_ovf[key] |= rows[:, col:col + q].any(axis=0)

    def _totals(self):
        q = self.q
        return ({k: np.zeros(q, np.int64) for k in self.bkeys},
                {k: np.zeros(q, np.int64) for k in self.bkeys},
                {k: np.zeros(q, bool) for k in self.okeys})

    def execute(self, state0: Dict[str, torch.Tensor],
                num_real_queries: int) -> RunResult:
        """Run the Q lanes from ``state0`` until every lane halts, at
        ``max_steps`` or at an overflow; lanes ``num_real_queries`` and up
        are bucket padding and start halted. The result reports the real
        lanes (``_batched_result``); its state is a copy."""
        if self.serve:
            raise ValueError("a serving loop runs a chunk at a time "
                             "(serve_chunk)")
        with self.replays_counted(), knob_scope(self.knobs):
            res = self._execute_batch(state0, num_real_queries)
        return _stamp_knobs(res, self.knobs, batched=True)

    def _execute_batch(self, state0, q_real: int) -> RunResult:
        t0 = time.perf_counter()
        self.load(state0)
        self.out.zero_()
        # the pad lanes are an input of the run, not part of the graph
        self.lanes[0].copy_(torch.arange(self.q, device=self.device)
                            >= q_real)
        self.go.fill_(self.max_steps > 0)
        chunked = self.mode == "chunked"
        q_bytes, q_msgs, q_ovf = self._totals()
        wrapped: set = set()
        times, dispatches, overhead = [], 0, 0.0
        n_read = self.out.numel() if chunked else 4
        while True:
            ts = time.perf_counter()
            self._dispatch()
            dispatches += 1
            t_enq = time.perf_counter()
            host = self._read(n_read)
            t_dev = time.perf_counter()
            steps, dead, overflow = (int(x) for x in host[:3])
            if chunked:  # the chunk's per-step rows
                self._add_rows(host[self.head:].reshape(self.K, -1),
                               q_bytes, q_msgs, q_ovf, wrapped)
            times.append(time.perf_counter() - ts)
            overhead += (t_enq - ts) + (time.perf_counter() - t_dev)
            if ((self.check_overflow and overflow) or wrapped or dead
                    or steps >= self.max_steps):
                break
        t_r = time.perf_counter()
        latch = False
        if not chunked:  # the lanes and the accumulators, once
            host = self._read(self.out.numel())
            latch = bool(host[3])
            self._add_rows(host[self.head:].reshape(1, -1), q_bytes, q_msgs,
                           q_ovf)
        lanes = host[4:self.head].reshape(4, self.q)
        state = {k: v.clone() for k, v in self.gathered(self.state).items()}
        overhead += time.perf_counter() - t_r
        return _batched_result(
            state, steps, lanes[0] != 0, lanes[1] != 0, q_bytes, q_msgs,
            lanes[3], q_real, mode=self.mode, dispatches=dispatches,
            wall=time.perf_counter() - t0, step_times=times,
            overhead=overhead, check_overflow=self.check_overflow,
            ovf_by=q_ovf, wrapped=wrapped, latch=latch,
            captured=self.cuda_graph is not None)

    def serve_chunk(self, age: np.ndarray, halted: np.ndarray,
                    overflow: np.ndarray):
        """One serving dispatch: up to K supersteps of every live lane,
        from the host's ``(Q,)`` ``age``, ``halted`` and ``overflow`` and
        the lanes' state in :attr:`state` (between dispatches the host
        writes an admitted query's state into its lane and reads a
        harvested lane's). Uploads the lane words in one copy and reads
        everything back in one. Returns ``(age, halted, overflow, d_steps,
        db, dm, dovf)`` as numpy: each lane's supersteps this chunk, and
        per channel each lane's bytes and messages (int64) and overflow
        flag."""
        q = self.q
        head = self.host[:self.head]
        words = head.numpy()
        words[:] = 0
        words[4:].reshape(4, q)[:3] = (halted, overflow, age)
        self.out[:self.head].copy_(head, non_blocking=self.cuda)
        live = ~(halted | (age >= self.max_steps))
        self.go.fill_(bool(live.any()) and not (
            self.check_overflow and bool(overflow.any())))
        with knob_scope(self.knobs):
            self._dispatch()
        host = self._read(self.out.numel())
        db, dm, dovf = self._totals()
        self._add_rows(host[self.head:].reshape(self.K, -1), db, dm, dovf)
        lanes = host[4:self.head].reshape(4, q)
        return (lanes[2].astype(np.int32), lanes[0] != 0, lanes[1] != 0,
                lanes[3], db, dm, dovf)
