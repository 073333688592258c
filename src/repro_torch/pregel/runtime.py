"""The worker runtime (paper Fig. 4): the host-driven superstep loop.

The port of the ``host`` execution mode of ``repro.pregel.runtime``:
one step per Python iteration over all W workers at once, then one
blocking readback of the halt vote, the overflow latch and the
per-channel traffic. PyTorch runs eagerly, so there is nothing to
compile; the ``fused`` and ``chunked`` modes (the whole loop on the
device) are not ported yet (ROADMAP).

Voting-to-halt: the step returns per-worker halt votes; the runtime ANDs
them. Per-step traffic counters are int32 per worker; the loop sums them
host-side in Python ints and raises ``TrafficWrapError`` on a negative
per-step total, ``ChannelOverflowError`` on a capacity overflow — the
JAX host mode's contract.

Batched query plane (:func:`run_batched_supersteps`, under
``Engine.run_batch``): one loop advances Q query instances per
superstep, state leaves ``(W, Q, n_loc, ...)``. Halting is per query: a
``(Q,)`` halted mask lives on the device, a lane that voted halt keeps
its state bit for bit (a ``torch.where`` over the pre-step live mask),
sends nothing and is charged nothing from the next step on — the halting
step itself still charges, as a solo run would. Pad lanes start halted.
One readback per superstep brings back the ``(Q,)`` halt and overflow
flags and the per-lane stats; per-lane totals are summed on the host in
int64. So per-query steps, outputs and per-channel bytes/msgs are
bit-identical to Q solo runs; overflow raises ``ChannelOverflowError``
naming the offending lanes (``qids``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core import aggregator, compose
from repro_torch.core.channel import ChannelContext, ChannelRegistry
from repro_torch.graph.pgraph import PartitionedGraph
from repro_torch.pregel import errors

MODES = ("host",)


@dataclasses.dataclass
class RunResult:
    state: Any
    steps: int
    halted: bool
    bytes_by_channel: Dict[str, int]
    msgs_by_channel: Dict[str, int]
    wall_time_s: float
    # host clock per superstep, each ending in the step's readback (which
    # waits for the device)
    step_times_s: list
    mode: str = "host"
    program: str = ""
    output: Any = None
    converged: bool = False
    # name -> bool, or name -> (Q,) bool for batched runs
    overflow_by_channel: Optional[Dict[str, Any]] = None
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


def _readback(halt_all, overflow, nbytes, nmsgs, novf):
    """One device-to-host copy of everything the loop reads per step.
    Returns (halt, overflow, {key: bytes}, {key: msgs}, {key: ovf})."""
    keys = sorted(nbytes)
    okeys = sorted(novf)
    parts = [halt_all.reshape(1), overflow.reshape(1)]
    parts += [nbytes[k] for k in keys] + [nmsgs[k] for k in keys]
    parts += [novf[k].any().reshape(1) for k in okeys]
    flat = torch.cat([p.to(torch.int64) for p in parts]).cpu().numpy()
    w = nbytes[keys[0]].numel() if keys else 0
    per = flat[2:2 + 2 * len(keys) * w].reshape(2, len(keys), w).sum(axis=2)
    ovf = flat[2 + 2 * len(keys) * w:]
    return (bool(flat[0]), bool(flat[1]),
            {k: int(per[0, i]) for i, k in enumerate(keys)},
            {k: int(per[1, i]) for i, k in enumerate(keys)},
            {k: bool(ovf[i]) for i, k in enumerate(okeys)})


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


def run_supersteps(
    graph: PartitionedGraph,
    step_fn: Callable,
    state0: Any,
    max_steps: int = 10_000,
    check_overflow: bool = True,
    mode: str = "host",
    channels: Optional[Any] = None,
) -> RunResult:
    """Run ``step_fn(ctx, graph, state, step)`` to halt, host-driven.

    state0: dict of ``(W, n_loc, ...)`` tensors on ``graph.device``.
    step_fn returns ``(new_state, halt)`` or ``(new_state, halt,
    overflow)``; halt/overflow are per-worker ``(W,)`` or scalar.
    channels: optional declaration of the stat keys (names, a composed
    channel such as ``compose.Stacked``, or a mixed sequence); every key
    then appears in the result, an undeclared key raises, and a declared
    key that no step reached raises.
    """
    if mode not in MODES:
        raise NotImplementedError(
            f"mode={mode!r} is not ported yet: only the host-driven loop "
            "runs (see ROADMAP: fused/chunked modes come after the batched "
            "plane)")
    registry = _registry(channels)
    W, n_loc = graph.num_workers, graph.n_loc
    bytes_acc: Dict[str, int] = {}
    msgs_acc: Dict[str, int] = {}
    ovf_acc: Dict[str, bool] = {}
    touched: set = set()
    state = state0
    halted = overflowed = False
    wrapped: set = set()
    step_times = []
    t0 = time.perf_counter()
    step = -1  # so max_steps=0 reports zero executed supersteps
    for step in range(max_steps):
        ts = time.perf_counter()
        ctx = ChannelContext(W, n_loc, graph.device, registry=registry,
                             route_cap=graph.route_cap)
        state, halt, overflow = _call_step(step_fn, ctx, graph, state, step)
        touched |= ctx.touched
        halt_all = aggregator.all_halted(ctx, halt)
        overflow_any = torch.as_tensor(overflow, device=graph.device).any()
        nbytes, nmsgs = ctx.stats()
        halt_now, ovf_now, db, dm, dovf = _readback(
            halt_all, overflow_any, nbytes, nmsgs, ctx.stats_ovf)
        step_times.append(time.perf_counter() - ts)
        for acc, delta in ((bytes_acc, db), (msgs_acc, dm)):
            for k, d in delta.items():
                if d < 0:
                    wrapped.add(k)
                acc[k] = acc.get(k, 0) + d
        for k, v in dovf.items():
            ovf_acc[k] = ovf_acc.get(k, False) or v
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
        state=state,
        steps=step + 1,
        halted=halted,
        bytes_by_channel=bytes_acc,
        msgs_by_channel=msgs_acc,
        wall_time_s=time.perf_counter() - t0,
        step_times_s=step_times,
        mode="host",
        converged=halted,
        overflow_by_channel=ovf_acc,
    )
    if overflowed:
        bad = sorted(k for k, v in ovf_acc.items() if v)
        raise errors.ChannelOverflowError(
            errors.overflow_message(step, bad),
            superstep=step, channels=bad, result=res)
    if wrapped:
        bad = sorted(wrapped)
        raise errors.TrafficWrapError(
            f"int32 traffic counter wrapped in channel(s) {', '.join(bad)} "
            f"at superstep {step} — per-step traffic exceeds int32 range",
            superstep=step, channels=bad, result=res)
    return res


# ---------------------------------------------------------------------------
# batched query plane: one loop advances Q query instances per superstep,
# with per-query halt voting, frozen state for halted queries, and
# per-query step/traffic attribution (Engine.run_batch rides this)
# ---------------------------------------------------------------------------


def _qmask(live: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Broadcast a (Q,) liveness mask against a (W, Q, ...) state leaf."""
    return live.reshape((1,) + live.shape + (1,) * (leaf.dim() - 2))


def _readback_lanes(halted, overflow, nbytes, nmsgs, novf):
    """One device-to-host copy of everything the batched loop reads per
    step: the (Q,) halt and overflow flags, the (W, Q) per-lane stats
    (summed over W on the host in int64) and the per-channel overflow
    latches. Returns (halted, overflow, {key: bytes (Q,)}, {key: msgs
    (Q,)}, {key: ovf (Q,)}) as numpy."""
    q = halted.numel()
    keys, okeys = sorted(nbytes), sorted(novf)
    parts = [halted, overflow] + [nbytes[k] for k in keys]
    parts += [nmsgs[k] for k in keys] + [novf[k].any(dim=0) for k in okeys]
    flat = torch.cat([p.reshape(-1).to(torch.int64) for p in parts])
    flat = flat.cpu().numpy()
    off = 2 * q + 2 * sum(nbytes[k].numel() for k in keys)
    w = nbytes[keys[0]].shape[0] if keys else 0
    per = flat[2 * q:off].reshape(2, len(keys), w, q).sum(axis=2)
    ovf = flat[off:].reshape(len(okeys), q).astype(bool)
    return (flat[:q].astype(bool), flat[q:2 * q].astype(bool),
            {k: per[0, i] for i, k in enumerate(keys)},
            {k: per[1, i] for i, k in enumerate(keys)},
            {k: ovf[i] for i, k in enumerate(okeys)})


def _batched_result(state, steps, halted_q, overflow_q, q_bytes, q_msgs,
                    steps_q, q_real, wall, step_times, check_overflow,
                    ovf_by, wrapped) -> RunResult:
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
        mode="host",
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
    return res


def run_batched_supersteps(
    graph: PartitionedGraph,
    step_fn: Callable,
    state0: Dict[str, torch.Tensor],
    num_real_queries: int,
    max_steps: int = 10_000,
    check_overflow: bool = True,
    channels: Optional[Any] = None,
) -> RunResult:
    """Run Q query lanes of ``step_fn`` to halt in one host-driven loop.

    state0: dict of ``(W, Q, n_loc, ...)`` tensors on ``graph.device``;
    lanes ``num_real_queries`` and up are padding and start halted. The
    step sees a batched ``ChannelContext`` (``num_queries=Q``) and
    returns ``(new_state, halt[, overflow])`` with ``(W, Q)`` (or scalar)
    votes. Returns a RunResult with the per-query views of the real lanes.
    """
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
                             query_live=live)
        new_state, halt, overflow = _call_step(step_fn, ctx, graph, state,
                                               step)
        touched |= ctx.touched
        state = {k: torch.where(_qmask(live, v), v, state[k])
                 for k, v in new_state.items()}
        halted = halted | aggregator.all_halted(ctx, halt)
        ovf_q = torch.as_tensor(overflow, device=dev).to(torch.bool).expand(
            W, q).any(dim=0) & live
        nbytes, nmsgs = ctx.stats()
        halted_np, ovf_now, db, dm, dovf = _readback_lanes(
            halted, ovf_q,
            {k: torch.where(live, v, 0) for k, v in nbytes.items()},
            {k: torch.where(live, v, 0) for k, v in nmsgs.items()},
            {k: v & live for k, v in ctx.stats_ovf.items()})
        step_times.append(time.perf_counter() - ts)
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
        if check_overflow and overflow_np[:q_real].any():
            break
        if wrapped:
            break
    if registry is not None and steps:
        _check_declared(registry, touched)
    return _batched_result(
        state, steps, halted_np, overflow_np, q_bytes, q_msgs, steps_q,
        q_real, time.perf_counter() - t0, step_times, check_overflow, q_ovf,
        wrapped)
