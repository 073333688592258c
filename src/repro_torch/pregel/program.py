"""VertexProgram — a vertex-centric program as a first-class value.

The port of ``repro.pregel.program``: a program's initial state, its
superstep, the channels it declares and how to read its answer back out,
as one immutable value that an :class:`~repro_torch.pregel.engine.Engine`
runs. ``step`` sees every worker at once: its graph argument is the whole
``PartitionedGraph`` and its state leaves are ``(W, n_loc, ...)``
tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional, Tuple

from repro_torch.graph.pgraph import PartitionedGraph


def _identity_extract(pg: PartitionedGraph, state: Any) -> Any:
    return state


@dataclasses.dataclass(eq=False)
class VertexProgram:
    """A declarative vertex-centric program.

    name: stable identifier, conventionally ``"<algorithm>:<variant>"``.
    init: ``init(pg) -> state0`` — a dict of ``(W, n_loc, ...)`` tensors
      on ``pg.device``.
    step: ``step(ctx, pg, state, step_idx)`` returning ``(new_state,
      halt)`` or ``(new_state, halt, overflow)``; ``halt``/``overflow``
      are per-worker ``(W,)`` votes or one scalar for all, and
      ``step_idx`` is the superstep number as a Python int.
    extract: ``extract(pg, final_state) -> output`` (e.g. global labels in
      old-id space), stored on ``RunResult.output``.
    channels: optional explicit declaration of the stat-key names.
    max_steps: default superstep budget (overridable per run).
    check_overflow: whether capacity overflow aborts the run.
    meta: free-form introspection data.
    """

    name: str
    init: Callable[[PartitionedGraph], Any]
    step: Callable
    extract: Callable[[PartitionedGraph, Any], Any] = _identity_extract
    channels: Optional[Tuple[str, ...]] = None
    max_steps: int = 10_000
    check_overflow: bool = True
    meta: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def channel_names(self) -> Tuple[str, ...]:
        """The declared stat-key set ('()' when relying on discovery)."""
        return tuple(sorted(self.channels)) if self.channels else ()

    def __repr__(self) -> str:
        chans = ",".join(self.channel_names()) or "<discovered>"
        return (f"VertexProgram({self.name!r}, max_steps={self.max_steps}, "
                f"channels=[{chans}])")
