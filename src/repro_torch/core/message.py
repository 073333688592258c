"""Standard message-passing channels (paper Table I).

The port of ``repro.core.message``: DirectMessage delivers arbitrary
(dst, payload) messages; CombinedMessage applies a combiner sender-side
(per destination, before the exchange) and receiver-side, yielding a
dense per-vertex combined value. Both ride the routed exchange
(``repro_torch.core.routing``) and put destination ids on the wire.

The sender-side combine is sort-free: the unique-destination list is
compacted with a counting prefix-sum (``routing.dedup_dense``) and the
values are reduced directly in that compact space. ``id_bytes`` are
charged once per *wire* message. Both combines are plain PyTorch
scatter reductions, as in the JAX package (which runs its reference
there, not the kernel); with the lattice combiners (min/max/or) they are
exact and order-independent on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core import combiners as cb
from repro_torch.core import routing
from repro_torch.core.channel import ChannelContext, payload_width


@dataclasses.dataclass
class Delivery:
    """Messages delivered to each worker (flattened over peers)."""

    dst_local: torch.Tensor           # (W, K) int32 local dst index (n_loc pad)
    payload: Dict[str, torch.Tensor]  # leaves (W, K, ...)
    mask: torch.Tensor                # (W, K) bool
    overflow: torch.Tensor            # (W,) bool


def _delivery(ctx: ChannelContext, routed: routing.Routed,
              capacity: int) -> Delivery:
    """Flatten a Routed into per-message local-index delivery form."""
    w, c = ctx.num_workers, capacity
    flat = {k: x.reshape((w, w * c) + tuple(x.shape[3:]))
            for k, x in (routed.payload or {}).items()}
    ids = routed.ids.reshape(w, w * c)
    mask = routed.mask.reshape(w, w * c)
    base = (ctx.me() * ctx.n_loc)[:, None]
    dst_local = torch.where(mask, ids - base, ctx.n_loc).to(torch.int32)
    return Delivery(dst_local=dst_local, payload=flat, mask=mask,
                    overflow=routed.overflow)


def direct_send(
    ctx: ChannelContext,
    dst: torch.Tensor,
    valid: torch.Tensor,
    payload: Dict[str, torch.Tensor],
    capacity: int,
    *,
    name: str = "direct_message",
    id_bytes: int = 4,
    wire_width: Optional[int] = None,
) -> Delivery:
    """DirectMessage: deliver (dst, payload) messages to dst's owner."""
    capacity = ctx.scale_capacity(name, capacity)
    routed = routing.route(ctx, dst, valid, payload, capacity)
    remote = routing.remote_count(ctx, routed.sent_count)
    width = id_bytes + (wire_width if wire_width is not None
                        else payload_width(payload))
    ctx.add_traffic(name, remote * width, remote)
    ctx.add_overflow(name, routed.overflow)
    return _delivery(ctx, routed, capacity)


def _combined_send_serial(ctx, dst, valid, v, combiner, capacity, use_kernel):
    """The CombinedMessage body. ``v`` is (W, M, D). Returns
    (out (W, n_loc, D), got (W, n_loc), overflow (W,), remote (W,))."""
    w, m, _ = v.shape
    n_total = w * ctx.n_loc
    ident = combiner.ident_for(v.dtype)

    # sender-side combine, sort-free: compact the occupied destinations
    # into an ascending unique list, then reduce in that compact space
    u_dst, pos = routing.dedup_dense(dst, valid, n_total)
    u_valid = u_dst != routing.BIG
    safe = torch.clamp(dst.to(torch.int64), 0, n_total - 1)
    seg = torch.where(valid, pos.gather(1, safe), m)
    u_vals = combiner.segment_reduce(v, seg, m)  # (W, m, D), u_dst-aligned

    routed = routing.route(ctx, u_dst, u_valid, {"v": u_vals}, capacity,
                           use_kernel=use_kernel)
    remote = routing.remote_count(ctx, routed.sent_count)

    deliv = _delivery(ctx, routed, capacity)
    flat_v = torch.where(deliv.mask[..., None], deliv.payload["v"], ident)
    out = combiner.segment_reduce(flat_v, deliv.dst_local, ctx.n_loc)
    got = cb.SUM.segment_reduce(deliv.mask.to(torch.int32), deliv.dst_local,
                                ctx.n_loc) > 0
    return out, got, routed.overflow, remote


def combined_send(
    ctx: ChannelContext,
    dst: torch.Tensor,
    valid: torch.Tensor,
    vals: torch.Tensor,
    combiner,
    capacity: int,
    *,
    name: str = "combined_message",
    use_kernel: Optional[bool] = None,
    wire_width: Optional[int] = None,
):
    """CombinedMessage: sender-side combine per destination, route, then
    receiver-side combine to a dense (W, n_loc[, D]) tensor.

    Args:
      dst: (W, M) int32 global destination ids; valid: (W, M) bool;
      vals: (W, M) or (W, M, D) values.
    Returns:
      (combined (W, n_loc[, D]), got_any (W, n_loc) bool, overflow (W,)).
    """
    combiner = cb.get(combiner)
    capacity = ctx.scale_capacity(name, capacity)
    squeeze = vals.dim() == 2
    v = vals[..., None] if squeeze else vals
    d = v.shape[2]
    out, got, overflow, remote = _combined_send_serial(
        ctx, dst, valid, v, combiner, capacity, use_kernel)
    width = 4 + (wire_width if wire_width is not None
                 else d * v.element_size())
    ctx.add_traffic(name, remote * width, remote)
    ctx.add_overflow(name, overflow)
    return (out[..., 0] if squeeze else out), got, overflow
