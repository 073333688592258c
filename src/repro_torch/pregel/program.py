"""VertexProgram — a vertex-centric program as a first-class value.

The port of ``repro.pregel.program``: a program's initial state, its
superstep, the channels it declares and how to read its answer back out,
as one immutable value that an :class:`~repro_torch.pregel.engine.Engine`
runs. ``step`` sees every worker at once: its graph argument is the whole
``PartitionedGraph`` and its state leaves are ``(W, n_loc, ...)``
tensors.

A program with a ``query_init`` is batchable
(``Engine.run_batch``): its step then also runs with state leaves of
``(W, Q, n_loc, ...)``, one lane per query, while the graph tensors stay
``(W, ...)``. The JAX package hides Q behind a ``vmap``; here the step
sees it, so a batchable step is written for both layouts —
:func:`lane_view` and :func:`gather_local` do the broadcasting.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional, Tuple

import torch

from repro_torch.core import compose
from repro_torch.graph.pgraph import PartitionedGraph


def _identity_extract(pg: PartitionedGraph, state: Any) -> Any:
    return state


def lane_view(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """View a ``(W, ...)`` graph tensor so that it broadcasts against
    ``like``, which may carry a query dim after W (``(W, Q, ...)`` under
    the batched query plane)."""
    extra = like.dim() - t.dim()
    return t.reshape(t.shape[:1] + (1,) * extra + t.shape[1:]) if extra else t


def gather_local(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[w, ..., idx[w, e]]``: per-edge values of a per-vertex tensor
    ``x`` ((W, n_loc) or (W, Q, n_loc)) at the local indices ``idx``
    ((W, E), e.g. ``raw_out.src_local``)."""
    i = lane_view(idx.long(), x)
    return x.gather(-1, i.expand(x.shape[:-1] + idx.shape[-1:]))


@dataclasses.dataclass(eq=False)
class VertexProgram:
    """A declarative vertex-centric program.

    name: stable identifier, conventionally ``"<algorithm>:<variant>"``.
    init: ``init(pg) -> state0`` — a dict of ``(W, n_loc, ...)`` tensors
      on ``pg.device``.
    step: ``step(ctx, pg, state, step_idx)`` returning ``(new_state,
      halt)`` or ``(new_state, halt, overflow)``; ``halt``/``overflow``
      are per-worker ``(W,)`` votes or one scalar for all, and
      ``step_idx`` is the superstep number: a Python int in host mode, a
      device int32 scalar in the fused and chunked modes, where the step
      is captured into a CUDA graph and so may not read a device value
      back to the host.
    extract: ``extract(pg, final_state) -> output`` (e.g. global labels in
      old-id space), stored on ``RunResult.output``.
    channels: optional explicit declaration of the stat keys: names, a
      composed channel with ``channel_names()`` (``compose.Stacked``), or
      a mixed sequence of both.
    query_init: optional ``query_init(pg, query) -> state0`` — the
      query-parametric init that makes the program batchable:
      ``Engine.run_batch(prog, pg, queries)`` stacks one state per query
      along dim 1 and advances all of them in one host loop (``init``
      stays the single-query default). ``extract`` is applied per query
      slice.
    max_steps: default superstep budget (overridable per run).
    check_overflow: whether capacity overflow aborts the run.
    meta: free-form introspection data.
    """

    name: str
    init: Callable[[PartitionedGraph], Any]
    step: Callable
    extract: Callable[[PartitionedGraph, Any], Any] = _identity_extract
    channels: Optional[Any] = None
    query_init: Optional[Callable[[PartitionedGraph, Any], Any]] = None
    max_steps: int = 10_000
    check_overflow: bool = True
    meta: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def channel_names(self) -> Tuple[str, ...]:
        """The declared stat-key set ('()' when relying on discovery)."""
        if self.channels is None:
            return ()
        return tuple(sorted(compose.channel_names_of(self.channels)))

    def __repr__(self) -> str:
        chans = ",".join(self.channel_names()) or "<discovered>"
        return (f"VertexProgram({self.name!r}, max_steps={self.max_steps}, "
                f"channels=[{chans}])")
