"""Standard message-passing channels (paper Table I).

The port of ``repro.core.message``: DirectMessage delivers arbitrary
(dst, payload) messages; CombinedMessage applies a combiner sender-side
(per destination, before the exchange) and receiver-side, yielding a
dense per-vertex combined value. Both ride the routed exchange
(``repro_torch.core.routing``) and put destination ids on the wire.

The sender-side combine is sort-free: the unique-destination list is
compacted with a counting prefix-sum (``routing.dedup_dense``) and the
values are reduced directly in that compact space. ``id_bytes`` are
charged once per *wire* message. Both combines go through
``kernels.ops.segment_reduce``: the lattice combiners (min/max/or) and
integer sums are plain PyTorch scatter reductions, exact in any order;
float sums, ``prod`` and ``min_by_first`` are order-sensitive, and on
the card they stable-sort their ids and run the ``segment_combine``
kernel — no float atomics, so two runs are bit-identical.

Under the batched query plane (a context with ``num_queries=Q``) and
``route_batch="union"`` (``routing.resolve_batch``, the default) a
CombinedMessage with a union-exact combiner dedups and routes ONCE over
the union frontier of all Q lanes (``_combined_send_union``): values are
``(W, Q, M[, D])``, the route pass is the ``bucket_ranks_lanes`` kernel,
and per-lane results and traffic are bit-identical to Q solo sends. A
combiner that is not union-exact (a float ``sum``), or
``route_batch="lane"``, runs the serial body once a lane, all lanes in
one pass (``_combined_send_serial`` over a lane dim). A DirectMessage
under the plane goes through ``routing.route_union`` (union) or one
route pass a lane (lane); its payload leaves are ``(W, Q, M, ...)`` and
its ``Delivery`` gains the Q dim after W.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core import combiners as cb
from repro_torch.core import routing
from repro_torch.core.channel import (TRAFFIC_DTYPE, ChannelContext,
                                      payload_width)
from repro_torch.kernels import ops as kops


@dataclasses.dataclass
class Delivery:
    """Messages delivered to each worker (flattened over peers); under
    the batched query plane every field has Q after W."""

    dst_local: torch.Tensor           # (W, K) int32 local dst index (n_loc pad)
    payload: Dict[str, torch.Tensor]  # leaves (W, K, ...)
    mask: torch.Tensor                # (W, K) bool
    overflow: torch.Tensor            # (W,) bool


def _delivery(ctx: ChannelContext, routed: routing.Routed,
              capacity: int) -> Delivery:
    """Flatten a Routed (with or without a lane dim) into per-message
    local-index delivery form."""
    w, c = ctx.num_workers, capacity
    lead = tuple(routed.slot.shape[:-1])
    flat = {k: x.reshape(lead + (w * c,) + tuple(x.shape[len(lead) + 2:]))
            for k, x in (routed.payload or {}).items()}
    ids = routed.ids.reshape(lead + (w * c,))
    mask = routed.mask.reshape(lead + (w * c,))
    base = (ctx.me() * ctx.n_loc).reshape((ctx.rows,) + (1,) * len(lead))
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
    """DirectMessage: deliver (dst, payload) messages to dst's owner.

    Under the batched query plane ``dst`` and ``valid`` are (W, M) or
    (W, Q, M), the payload leaves (W, Q, M, ...), and the delivery and
    the traffic are per lane: one union route pass
    (``routing.route_union``) or, under ``route_batch="lane"``, one pass
    a lane."""
    capacity = ctx.scale_capacity(name, capacity)
    routed = _route_maybe_union(ctx, dst, valid, payload, capacity)
    remote = routing.remote_count(ctx, routed.sent_count)
    width = id_bytes + (wire_width if wire_width is not None
                        else payload_width(payload, ctx.batched))
    ctx.add_traffic(name, remote * width, remote)
    ctx.add_overflow(name, routed.overflow)
    return _delivery(ctx, routed, capacity)


def _route_maybe_union(ctx, dst, valid, payload, capacity):
    """The routed-channel dispatch: one route pass solo; under the
    batched query plane the shared union pass (``route_batch="union"``)
    or one pass a lane (``"lane"``)."""
    if not ctx.batched:
        return routing.route(ctx, dst, valid, payload, capacity)
    if routing.resolve_batch() == "union":
        return routing.route_union(ctx, dst, valid, payload, capacity)
    dst_l, valid_l = routing.lane_views(ctx, dst, valid)
    return routing.route(ctx, dst_l, valid_l, payload, capacity)


def monolithic_send(
    ctx: ChannelContext,
    dst: torch.Tensor,
    valid: torch.Tensor,
    payload: Dict[str, torch.Tensor],
    capacity: int,
    *,
    pad_width: int,
    name: str = "pregel_message",
) -> Delivery:
    """Pregel-monolithic emulation (the paper's Table IV baseline): a
    DirectMessage whose every message is padded to the program-wide
    widest message, ``pad_width`` bytes, with no per-channel combiner; a
    remote message costs ``4 + pad_width`` bytes (the JAX package's
    ``monolithic_send``)."""
    capacity = ctx.scale_capacity(name, capacity)
    routed = _route_maybe_union(ctx, dst, valid, payload, capacity)
    remote = routing.remote_count(ctx, routed.sent_count)
    ctx.add_traffic(name, remote * (4 + pad_width), remote)
    ctx.add_overflow(name, routed.overflow)
    return _delivery(ctx, routed, capacity)


# combiners whose segment reductions are order-independent for any dtype
_UNION_EXACT_LATTICE = ("min", "max", "or")


def _union_exact(combiner, dtype: torch.dtype) -> bool:
    """Whether the union-frontier batched path reproduces serial results
    bit for bit for this combiner: lattice ops are order-independent
    under the union's slot reordering; sum/prod only on an exact dtype
    (float reassociation would round differently)."""
    if combiner.name in _UNION_EXACT_LATTICE:
        return True
    return combiner.name in ("sum", "prod") and not dtype.is_floating_point


def _combined_send_serial(ctx, dst, valid, v, combiner, capacity, use_kernel):
    """The CombinedMessage body. ``v`` is (W, M, D). Returns
    (out (W, n_loc, D), got (W, n_loc), overflow (W,), remote (W,)).
    Under the batched query plane it is each lane's own body, all lanes
    in one pass: ``v`` is (W, Q, M, D), ``dst``/``valid`` (W, M) or
    (W, Q, M), and every result gains Q after W."""
    if ctx.batched:
        dst, valid = routing.lane_views(ctx, dst, valid)
    m = v.shape[-2]
    n_total = ctx.num_workers * ctx.n_loc
    ident = combiner.ident_for(v.dtype)

    # sender-side combine, sort-free: compact the occupied destinations
    # into an ascending unique list, then reduce in that compact space
    u_dst, pos = routing.dedup_dense(dst, valid, n_total)
    u_valid = u_dst != routing.BIG
    safe = torch.clamp(dst.to(torch.int64), 0, n_total - 1)
    seg = torch.where(valid, pos.gather(-1, safe), m)
    # (W, [Q,] m, D), u_dst-aligned
    u_vals = kops.segment_reduce(v, seg, m, combiner, use_kernel=use_kernel)

    routed = routing.route(ctx, u_dst, u_valid, {"v": u_vals}, capacity,
                           use_kernel=use_kernel)
    remote = routing.remote_count(ctx, routed.sent_count)

    deliv = _delivery(ctx, routed, capacity)
    flat_v = torch.where(deliv.mask[..., None], deliv.payload["v"], ident)
    out = kops.segment_reduce(flat_v, deliv.dst_local, ctx.n_loc, combiner,
                              use_kernel=use_kernel)
    got = cb.SUM.segment_reduce(deliv.mask.to(torch.int32), deliv.dst_local,
                                ctx.n_loc) > 0
    return out, got, routed.overflow, remote


def _combined_send_union(ctx, dst, valid, v, combiner, capacity,
                         use_kernel):
    """CombinedMessage across the Q query lanes with ONE dedup and route
    pass over their union frontier. ``dst`` is (W, M) (lane-invariant,
    e.g. graph edges) or (W, Q, M); ``valid`` (W, M) or (W, Q, M); ``v``
    (W, Q, M, D). Lanes that voted halt send nothing. Per-lane combined
    values ride the wire as a (slots, Q, D) lane matrix beside a
    (slots, Q) membership matrix.

    Returns (out (W, Q, n_loc, D), got (W, Q, n_loc), overflow (W, Q),
    remote (W, Q)); per lane bit-identical to the serial body whenever
    the union pass does not overflow and the combiner is union-exact.
    A lane's union rank dominates its solo rank, so ``overflow`` is a
    superset of the solo overflow, never a silent drop."""
    W, n_loc, q = ctx.num_workers, ctx.n_loc, ctx.num_queries
    R = ctx.rows  # the rows this process holds (W, or 1 on a rank)
    n_total = W * n_loc
    m, d = v.shape[2], v.shape[3]
    c = capacity
    routing._check_slot_range(W, c)
    ident = combiner.ident_for(v.dtype)
    dst_l, valid_l = routing.lane_views(ctx, dst, valid)

    # ---- union dedup over the id space (one histogram, all lanes) ----
    u_cap = min(q * m, n_total)
    u_dst, pos = routing.union_dedup(dst_l, valid_l, n_total, u_cap)
    u_valid = u_dst != routing.BIG
    # each lane combines into the SHARED compact space: entry u of lane l
    # is column u * Q + l of a (W, u_cap * Q) grid (dump column u_cap * Q)
    # (in place: at scale these are (W, Q·M) int64 index tensors)
    lane_seg = pos.gather(1, torch.clamp(
        dst_l.reshape(R, q * m).long(), 0, n_total - 1)).long()
    lane_seg.view(R, q, m).mul_(q).add_(ctx.query_index()[None, :, None])
    lane_seg.masked_fill_(~valid_l.reshape(R, q * m), u_cap * q)
    u_vals = combiner.segment_reduce(
        v.reshape(R, q * m, d), lane_seg, u_cap * q).reshape(R, u_cap, q, d)
    # (dump column u_cap * Q, padded so that rows stay 16-byte aligned for
    # the route kernel, which reads the rows in place)
    lanes = torch.zeros((R, u_cap * q + 16), dtype=torch.bool,
                        device=v.device).scatter_(1, lane_seg, True)
    lanes = lanes[:, :u_cap * q].reshape(R, u_cap, q)  # (W, u_cap, Q)

    # ---- ONE bucket-route pass over the union unique list ----
    owner = torch.clamp(u_dst // n_loc, 0, W - 1)
    key_u = torch.where(u_valid, owner, W).to(torch.int32)
    rank, _, lane_counts = routing.union_ranks(key_u, lanes, W,
                                               use_kernel=use_kernel)
    fits = rank < c
    slot = torch.where(u_valid & fits, key_u * c + rank, W * c)
    overflow = (lanes & ~fits[..., None]).any(dim=1)  # (W, Q)
    sent_l = torch.clamp(lane_counts, max=c)  # (W, W_dst, Q)
    me = ctx.me()
    remote = (sent_l.sum(dim=1) - ctx.workers.own(sent_l)).to(TRAFFIC_DTYPE)

    # ---- pack + exchange: ids, lane membership, lane values ----
    recv_ids = routing.exchange(ctx, routing.pack(
        slot, u_dst, W * c, routing.BIG).reshape(R, W, c))
    recv_has = routing.exchange(ctx, routing.pack(
        slot, lanes, W * c, False).reshape(R, W, c, q))
    # a lane that does not send an entry holds the identity there (an
    # empty segment), so the values need no membership mask
    recv_v = routing.exchange(ctx, routing.pack(
        slot, u_vals, W * c, ident).reshape(R, W, c, q, d))

    # ---- receiver-side per-lane combine: one segment pass over Q·D ----
    flat_ids = recv_ids.reshape(R, W * c)
    dst_local = torch.where(flat_ids != routing.BIG,
                            flat_ids - (me * n_loc)[:, None],
                            n_loc).to(torch.int32)
    out = combiner.segment_reduce(recv_v.reshape(R, W * c, q * d),
                                  dst_local, n_loc)
    out = out.reshape(R, n_loc, q, d).permute(0, 2, 1, 3)
    got = cb.SUM.segment_reduce(recv_has.reshape(R, W * c, q).to(torch.int32),
                                dst_local, n_loc) > 0
    return out, got.transpose(1, 2), overflow, remote


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
    Under the batched query plane (``ctx.batched``) ``vals`` is
    (W, Q, M[, D]), ``valid`` (W, M) or (W, Q, M) and ``dst`` (W, M) or
    (W, Q, M), and every result gains the Q dim after W: one union pass
    for a union-exact combiner under ``route_batch="union"``, else the
    serial body once a lane.
    Returns:
      (combined (W, n_loc[, D]), got_any (W, n_loc) bool, overflow (W,)).
    """
    combiner = cb.get(combiner)
    capacity = ctx.scale_capacity(name, capacity)
    squeeze = vals.dim() == (3 if ctx.batched else 2)
    v = vals[..., None] if squeeze else vals
    d = v.shape[-1]
    if (ctx.batched and routing.resolve_batch() == "union"
            and _union_exact(combiner, v.dtype)):
        send = _combined_send_union
    else:  # solo, or each lane's serial body
        send = _combined_send_serial
    out, got, overflow, remote = send(
        ctx, dst, valid, v, combiner, capacity, use_kernel)
    width = 4 + (wire_width if wire_width is not None
                 else d * v.element_size())
    ctx.add_traffic(name, remote * width, remote)
    ctx.add_overflow(name, overflow)
    return (out[..., 0] if squeeze else out), got, overflow
