"""Structured failure taxonomy for the pregel runtime.

A copy of the JAX package's taxonomy, so the port raises the same types
with the same context: the failing superstep, the offending channel
name(s) where attribution exists, and the partial
:class:`~repro_torch.pregel.runtime.RunResult` at the failure point.

All three subclass ``RuntimeError`` so that pre-existing
``except RuntimeError`` / ``pytest.raises(RuntimeError)`` call sites keep
working unchanged.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple


class ExecutionError(RuntimeError):
    """Base class: a pregel run failed at a known superstep.

    Attributes:
      superstep: the 0-based superstep at (or by) which the failure was
        detected — for chunked mode this is the dispatch boundary where
        the device flag was observed, i.e. an upper bound.
      channels: names of the offending channels, ``()`` when the failing
        mode cannot attribute (e.g. the fused wrap latch is global).
      result: the partial RunResult reconstructed from the carry at the
        failure point (state/steps/traffic as of the failed superstep),
        or None when no carry was recoverable.
    """

    def __init__(self, message: str, *, superstep: Optional[int] = None,
                 channels: Sequence[str] = (), result=None):
        super().__init__(message)
        self.superstep = superstep
        self.channels: Tuple[str, ...] = tuple(channels)
        self.result = result


class ChannelOverflowError(ExecutionError):
    """A routed channel's per-peer slot capacity overflowed: at least one
    valid message did not fit and would have been dropped. The run's
    state past ``superstep`` is not trustworthy; re-run with larger caps
    (``Engine(on_overflow="escalate")`` does this automatically).

    ``qids`` names the offending query lanes under the batched/serving
    planes (``()`` for unbatched runs)."""

    def __init__(self, message: str, *, superstep: Optional[int] = None,
                 channels: Sequence[str] = (), result=None,
                 qids: Sequence[int] = ()):
        super().__init__(message, superstep=superstep, channels=channels,
                         result=result)
        self.qids: Tuple[int, ...] = tuple(int(q) for q in qids)


class PlanRangeError(ExecutionError):
    """A routing-plan extent would overflow the int32 id/slot space.

    Wire slots are ``owner * C + rank`` and the scatter-plan tables
    (``pack_slot`` / ``edge_src`` / ``recv_local``) are int32: at
    production ``W x C`` a slot id past ``2**31 - 1`` silently wraps into
    another worker's range and corrupts routes instead of failing. The
    bound is validated at *plan build / trace time* (it is a pure
    function of the static caps), so the failure is a structured error
    before any superstep runs — ``superstep`` is always None and
    ``channels`` names the offending plan or channel where known."""


class NonConvergenceError(ExecutionError):
    """The run exhausted ``max_steps`` without a unanimous halt vote.
    Unlike the other two, the attached ``result`` is a *complete* result
    at the step budget — raised only under ``Engine(on_nonconverged=
    "raise")``; the default merely records ``RunResult.converged=False``.
    """


class TrafficWrapError(ExecutionError):
    """An int32 traffic counter wrapped. Fused mode latches accumulator
    decrease across the whole run (no per-channel attribution); host and
    chunked modes detect a negative per-step delta and name the channel.
    Totals are unreliable — switch to ``mode="chunked"`` (host-side int64
    accumulation) or reduce per-step traffic."""


def overflow_message(superstep, channels, qids=()) -> str:
    """The uniform overflow message (kept matching the historical
    "capacity overflow" phrasing that tests and docs grep for)."""
    chan = f" in channel(s) {', '.join(channels)}" if channels else ""
    lanes = f" for queries {list(qids)}" if qids else ""
    return (
        f"channel capacity overflow{chan}{lanes} at superstep {superstep}"
        " — increase the channel capacity in the routing plan, or run "
        "under Engine(on_overflow=\"escalate\") to retry with escalated "
        "caps automatically"
    )
