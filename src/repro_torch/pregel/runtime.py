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
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from repro_torch.core import aggregator
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
    overflow_by_channel: Optional[Dict[str, bool]] = None

    @property
    def total_bytes(self) -> int:
        return int(sum(self.bytes_by_channel.values()))

    @property
    def total_msgs(self) -> int:
        return int(sum(self.msgs_by_channel.values()))


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


def run_supersteps(
    graph: PartitionedGraph,
    step_fn: Callable,
    state0: Any,
    max_steps: int = 10_000,
    check_overflow: bool = True,
    mode: str = "host",
    channels: Optional[Sequence[str]] = None,
) -> RunResult:
    """Run ``step_fn(ctx, graph, state, step)`` to halt, host-driven.

    state0: dict of ``(W, n_loc, ...)`` tensors on ``graph.device``.
    step_fn returns ``(new_state, halt)`` or ``(new_state, halt,
    overflow)``; halt/overflow are per-worker ``(W,)`` or scalar.
    channels: optional declaration of the stat-key names; every key then
    appears in the result and an undeclared key raises.
    """
    if mode not in MODES:
        raise NotImplementedError(
            f"mode={mode!r} is not ported yet: only the host-driven loop "
            "runs (see ROADMAP: fused/chunked modes come after the batched "
            "plane)")
    registry = ChannelRegistry.declare(channels) if channels else None
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
        out = step_fn(ctx, graph, state, step)
        if len(out) == 3:
            state, halt, overflow = out
        else:
            (state, halt), overflow = out, False
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
        phantom = set(registry.names) - touched
        if phantom:
            raise ValueError(
                f"declared channels {tuple(sorted(phantom))} were never "
                f"reached by the step function (reached: "
                f"{tuple(sorted(touched))}) — stale or misspelled "
                "declaration")
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
