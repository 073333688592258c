"""Channel composition layer (paper §V).

The port of ``repro.core.compose``. Optimizations become composable once
they are channels: the S-V case study stacks request-respond,
scatter-combine and the combiner to beat the unoptimized program on
rounds and bytes. This module makes such stacks values:

  - ``Stacked`` — a named bundle of channel components. Each component
    accounts its traffic under a namespaced stat key
    (``<stack>/<component>[/<sub>]``), and the stack declares its whole
    key set (``channel_names()``) to the runtime.
  - ``scoped``/``child_context``/``merge_child`` — accounting in a child
    context that folds back into the parent under a prefix, optionally
    masked by a 0/1 select.
  - ``fused_exchange`` — several *independent* planned exchanges share
    one collective round.
  - ``switch_by_density`` — two implementations of one logical exchange
    (a dense broadcast and a sparse push), chosen per superstep by a
    worker-uniform density. Both run every superstep; the choice decides
    which result is used and which branch's traffic is charged.
    ``density_adaptive_combine`` is its canonical instance.

Composition never changes a channel's semantics: every combinator is a
function over the same ``(W, ...)`` tensors.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs import knobs
from repro_torch.core import message as msg
from repro_torch.core import request_respond as rr
from repro_torch.core.combiners import SUM
from repro_torch.core.channel import (TRAFFIC_DTYPE, ChannelContext,
                                      channel_span, key_under, on_device)
from repro_torch.core.routing import exchange

#: the density-switch threshold knob (explicit > dense_threshold_scope >
#: REPRO_DENSE_THRESHOLD > 0.1): the frontier fraction at or above which
#: :func:`density_adaptive_combine` takes the planned dense broadcast
DENSE_THRESHOLD = knobs.Knob(
    "dense_threshold", env="REPRO_DENSE_THRESHOLD", default=0.1,
    parse=float, coerce=float)


def resolve_dense_threshold(threshold: Optional[float] = None) -> float:
    """The density-switch threshold for a call site (explicit > scope >
    env > 0.1)."""
    return DENSE_THRESHOLD.resolve(threshold)


def dense_threshold_scope(threshold: Optional[float]):
    """Pin the density-switch threshold for every adaptive combine under
    the scope."""
    return DENSE_THRESHOLD.scope(threshold)


# ---------------------------------------------------------------------------
# scoped accounting: child contexts whose stats fold back, namespaced
# ---------------------------------------------------------------------------


def child_context(ctx: ChannelContext, prefix: str = "") -> ChannelContext:
    """An open child context (no registry) sharing ctx's topology, device,
    capacity scales, ``route_cap``, query-plane fields and device-loop
    mark. ``prefix`` (the
    name its stats will be merged under) composes the namespace, so
    capacity-scale lookups inside the child see full channel names."""
    return ChannelContext(
        ctx.num_workers, ctx.n_loc, ctx.device, cap_scales=ctx.cap_scales,
        name_prefix=ctx.full_name(prefix) if prefix else ctx.name_prefix,
        route_cap=ctx.route_cap, num_queries=ctx.num_queries,
        query_live=ctx.query_live, device_loop=ctx.device_loop,
        workers=ctx.workers)


def merge_child(ctx: ChannelContext, child: ChannelContext, prefix: str = "",
                select=None) -> None:
    """Fold a child's stats into ``ctx`` under ``prefix/<key>``.

    select: optional 0/1 int tensor (scalar or per worker) multiplied into
    every counter — how :func:`switch_by_density` charges only the chosen
    branch; an unselected branch's overflow does not latch either.
    """
    for key in child.stats_bytes:
        name = f"{prefix}/{key}" if prefix else key
        nb, nm = child.stats_bytes[key], child.stats_msgs[key]
        if select is not None:
            nb, nm = nb * select, nm * select
        ctx.add_traffic(name, nb, nm)
    for key, ovf in child.stats_ovf.items():
        name = f"{prefix}/{key}" if prefix else key
        if select is not None:
            ovf = ovf & (select != 0)
        ctx.add_overflow(name, ovf)


@contextlib.contextmanager
def scoped(ctx: ChannelContext, prefix: str, select=None):
    """``with scoped(ctx, "sv/jump") as sub:`` — namespaced accounting."""
    sub = child_context(ctx, prefix)
    yield sub
    merge_child(ctx, sub, prefix, select)


# ---------------------------------------------------------------------------
# Stacked: a named, declarable bundle of channel components
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Component:
    """One constituent channel of a :class:`Stacked` composition.

    fn: ``fn(ctx, name, *args, **kw)`` — a channel call that accounts its
      traffic under ``name``.
    stats: the stat-key suffixes the channel adds under its name — ``()``
      for a single-key channel, ``("request", "respond")`` for
      request-respond.
    """

    fn: Callable
    stats: Tuple[str, ...] = ()

    def names_under(self, name: str) -> Tuple[str, ...]:
        if not self.stats:
            return (name,)
        return tuple(f"{name}/{s}" for s in self.stats)


class Stacked:
    """A composition of channels with per-component traffic attribution.

    ``stack.call(ctx, key, *args)`` invokes component ``key`` under the
    stat name ``<stack.name>/<key>``; ``channel_names()`` is the stack's
    whole key set, which a program declares (``VertexProgram.channels``).
    """

    def __init__(self, name: str, components: Dict[str, Component]):
        self.name = name
        self.components = dict(components)

    def call(self, ctx: ChannelContext, key: str, *args, **kw):
        comp = self.components[key]
        name = f"{self.name}/{key}"
        with channel_span(ctx, name):
            return comp.fn(ctx, name, *args, **kw)

    def channel_names(self) -> Tuple[str, ...]:
        names: List[str] = []
        for key, comp in self.components.items():
            names.extend(comp.names_under(f"{self.name}/{key}"))
        return tuple(sorted(names))


def stacked(name: str, **components: Component) -> Stacked:
    """Sugar: ``stacked("sv", pointer=Component(...), ...)``."""
    return Stacked(name, components)


def request_component() -> Component:
    """The request-respond channel as a stack component: args
    ``(dst, valid, vals, capacity)``, stats ``request``/``respond``."""

    def fn(ctx, name, dst, valid, vals, capacity):
        return rr.request(ctx, dst, valid, vals, capacity=capacity, name=name)

    return Component(fn, stats=("request", "respond"))


def combined_component(combiner) -> Component:
    """A CombinedMessage send as a stack component: args
    ``(dst, valid, vals, capacity)``."""

    def fn(ctx, name, dst, valid, vals, capacity):
        return msg.combined_send(ctx, dst, valid, vals, combiner,
                                 capacity=capacity, name=name)

    return Component(fn)


def channel_names_of(channels) -> Tuple[str, ...]:
    """Normalize a ``channels=`` declaration: a single name, a composed
    channel (anything with ``channel_names()``), or a mixed sequence."""
    if isinstance(channels, str):
        return (channels,)
    if hasattr(channels, "channel_names"):
        return tuple(channels.channel_names())
    names: List[str] = []
    for c in channels:
        if hasattr(c, "channel_names"):
            names.extend(c.channel_names())
        else:
            names.append(c)
    return tuple(names)


# ---------------------------------------------------------------------------
# fused_exchange: several independent exchanges, one collective round
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PlannedExchange:
    """A channel exchange split at the collective boundary.

    ``payload`` holds the ready-to-send buffers — a dict of
    ``(W_src, W_dst, C, ...)`` tensors where ``[q, p]`` is worker q's
    block for peer p. ``finish(recv)`` consumes the identically shaped
    received dict (``[p, q]`` = block from q) and produces the channel's
    result. ``nbytes``/``nmsgs`` is the (W,) remote traffic accounted
    under ``name``.
    """

    name: str
    payload: Dict[str, torch.Tensor]
    finish: Callable[[Dict[str, torch.Tensor]], Any]
    nbytes: Any
    nmsgs: Any


def fused_exchange(ctx: ChannelContext,
                   parts: Sequence[PlannedExchange]) -> List[Any]:
    """Execute several planned exchanges in one collective round: all
    send buffers of one dtype are flattened to ``(W, W, -1)``,
    concatenated and exchanged together; each part's ``finish`` runs on
    its own slice, in ``parts`` order, and each part's traffic is
    accounted under its own name. The parts must be data-independent.
    The exchange is a ``channel:<full names joined by +>`` device span."""
    with channel_span(ctx, *(p.name for p in parts)):
        groups: Dict[torch.dtype, list] = {}
        for pi, part in enumerate(parts):
            for key, leaf in part.payload.items():
                groups.setdefault(leaf.dtype, []).append((pi, key, leaf))

        recv: List[Dict[str, torch.Tensor]] = [{} for _ in parts]
        w = ctx.num_workers
        for items in groups.values():
            rows = items[0][2].shape[0]
            cols = [leaf.reshape(rows, w, -1) for _, _, leaf in items]
            back = exchange(ctx, torch.cat(cols, dim=2) if len(cols) > 1
                            else cols[0])
            off = 0
            for (pi, key, leaf), col in zip(items, cols):
                width = col.shape[2]
                recv[pi][key] = back[:, :, off:off + width].reshape(leaf.shape)
                off += width

        results = []
        for pi, part in enumerate(parts):
            ctx.add_traffic(part.name, part.nbytes, part.nmsgs)
            results.append(part.finish(recv[pi]))
        return results


# ---------------------------------------------------------------------------
# switch_by_density: density-directed choice between two channel impls
# ---------------------------------------------------------------------------


def global_fraction(ctx: ChannelContext, local_count,
                    local_total) -> torch.Tensor:
    """Worker-uniform fraction ``sum(count) / sum(total)``: a float32
    ``(W,)`` tensor, the same value on every worker (the port of the
    ``psum`` pair). Counts are per worker, ``(W,)`` (``(1,)`` on a rank of
    a group); the workers layer sums them in index order on both
    backends."""
    both = torch.stack([
        on_device(x, ctx.device, torch.float32).expand(ctx.rows)
        for x in (local_count, local_total)], dim=-1)
    num, den = ctx.workers.reduce(both, SUM)[0].unbind(-1)
    frac = num / torch.clamp(den, min=1.0)
    return frac.expand(ctx.rows)


def _select(flag: torch.Tensor, a, b):
    """``where(flag, a, b)`` over a tensor or matching tuples of tensors,
    the per-worker ``flag`` broadcast along each leaf's trailing dims."""
    if isinstance(a, tuple):
        return tuple(_select(flag, x, y) for x, y in zip(a, b))
    f = flag.reshape(flag.shape + (1,) * (a.dim() - flag.dim()))
    return torch.where(f, a, b)


def switch_by_density(
    ctx: ChannelContext,
    name: str,
    density,
    threshold: Optional[float],
    dense_fn: Callable[[ChannelContext], Any],
    sparse_fn: Callable[[ChannelContext], Any],
):
    """Select between two implementations of one logical exchange.

    ``dense_fn(sub_ctx)`` and ``sparse_fn(sub_ctx)`` return results of
    identical structure (a tensor, or a tuple of them); ``density``
    must be worker-uniform (use :func:`global_fraction`). Returns
    ``(result, use_dense)``: the dense result where ``density >=
    threshold``, the sparse one elsewhere.

    Both branches run every superstep (as the JAX package traces both);
    only the chosen branch's traffic is charged, under
    ``<name>/dense/...`` and ``<name>/sparse/...``. ``threshold=None``
    resolves through the :data:`DENSE_THRESHOLD` knob. The whole is a
    ``channel:<full name>`` device span.
    """
    with channel_span(ctx, name):
        use_dense = (on_device(density, ctx.device, torch.float32)
                     >= resolve_dense_threshold(threshold))
        d_ctx = child_context(ctx, f"{name}/dense")
        s_ctx = child_context(ctx, f"{name}/sparse")
        d_out = dense_fn(d_ctx)
        s_out = sparse_fn(s_ctx)
        sel = use_dense.to(TRAFFIC_DTYPE)
        merge_child(ctx, d_ctx, f"{name}/dense", select=sel)
        merge_child(ctx, s_ctx, f"{name}/sparse", select=1 - sel)
        return _select(use_dense, d_out, s_out), use_dense


def density_adaptive_combine(
    ctx: ChannelContext,
    name: str,
    density,
    threshold: Optional[float],
    *,
    plan,
    dense_vals: torch.Tensor,
    dst: torch.Tensor,
    valid: torch.Tensor,
    sparse_vals: torch.Tensor,
    combiner,
    capacity: int,
):
    """Routed-vs-planned exchange for one logical neighborhood combine,
    selected by live frontier density: the planned positional
    ScatterCombine broadcast (``plan`` + ``dense_vals``; no ids on the
    wire, cost independent of the frontier) against the routed
    CombinedMessage push (``dst``/``valid``/``sparse_vals``; ids on the
    wire, only active messages travel).

    Returns ``(combined (W, n_loc[, D]) — combiner identity where nothing
    arrived, overflow (W,), use_dense)``; traffic lands under
    ``<name>/dense/scatter_combine`` or
    ``<name>/sparse/combined_message``.
    """
    # scatter_combine imports this module (PlannedExchange), so it is
    # imported here rather than at the top
    from repro_torch.core import scatter_combine as sc

    def dense(sub):
        out = sc.broadcast_combine(sub, plan, dense_vals, combiner)
        return out, torch.zeros(ctx.rows, dtype=torch.bool,
                                device=ctx.device)

    def sparse(sub):
        out, _, ovf = msg.combined_send(sub, dst, valid, sparse_vals,
                                        combiner, capacity=capacity)
        return out, ovf

    (result, overflow), use_dense = switch_by_density(
        ctx, name, density, threshold, dense, sparse)
    return result, overflow, use_dense


# ---------------------------------------------------------------------------
# stat helpers for namespaced keys
# ---------------------------------------------------------------------------


def group_stats(stats: Dict[str, int]) -> Dict[str, int]:
    """Collapse namespaced stats to per-top-level-prefix totals."""
    out: Dict[str, int] = {}
    for key, val in stats.items():
        top = key.split("/", 1)[0]
        out[top] = out.get(top, 0) + val
    return out


def stats_under(stats: Dict[str, int], prefix: str) -> Dict[str, int]:
    """The subset of ``stats`` belonging to ``prefix`` (exact or nested)."""
    return {k: v for k, v in stats.items() if key_under(k, prefix)}
