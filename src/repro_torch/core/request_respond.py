"""Request-Respond channel (paper §IV-C2).

The port of ``repro.core.request_respond``. Every vertex may request an
attribute of any other vertex. The channel dedups requests to the same
destination per worker (``routing.dedup_dense``, no sort), sends only
the unique ids, and the responder replies with a positionally ordered
value list — no ids on the respond wire (``routing.reply``). Traffic is
charged per *wire* message: the unique ids on the request wire, the
positional values on the respond wire.

The channel contributes two stat keys — ``<name>/request`` and
``<name>/respond`` — on every call, even when no request is valid (zero
traffic, not a missing key).

Under the batched query plane (``route_batch="union"``, the default)
the Q lanes share one dedup and one route pass (:func:`_request_union`,
the ``bucket_ranks_lanes`` kernel on the card): unique ids cross the
request wire once per worker pair however many lanes ask, and the
responses come back as a positional ``(slots, Q·D)`` lane matrix. Under
``route_batch="lane"`` each lane runs the serial body, all lanes in one
pass (:func:`_request_core` over a lane dim).
"""
from __future__ import annotations

import torch

from repro_torch.core import routing
from repro_torch.core.channel import (TRAFFIC_DTYPE, ChannelContext,
                                      traced_channel)


def _request_core(ctx: ChannelContext, dst, valid, rv, capacity):
    """The request/respond body over all W workers. ``rv`` is
    (W, n_loc, D). Returns (out (W, R, D), overflow (W,), remote (W,));
    traffic is charged by the caller. Under the batched query plane it
    is each lane's own body, all lanes in one pass: ``rv`` is
    (W, Q, n_loc, D), ``dst``/``valid`` (W, R) or (W, Q, R), and every
    result gains Q after W."""
    if ctx.batched:
        dst, valid = routing.lane_views(ctx, dst, valid)
    w, n_loc, d = ctx.num_workers, ctx.n_loc, rv.shape[-1]
    r = dst.shape[-1]
    lead = tuple(dst.shape[:-1])
    n_total = w * n_loc

    # --- dedup: one compact entry per unique destination (sort-free) ---
    u_dst, pos = routing.dedup_dense(dst, valid, n_total)
    u_valid = u_dst != routing.BIG

    # --- request phase: ids only ---
    routed = routing.route(ctx, u_dst, u_valid, {}, capacity)
    remote = routing.remote_count(ctx, routed.sent_count)

    # --- respond phase: positional values, no ids ---
    base = (ctx.me() * n_loc).reshape((ctx.rows,) + (1,) * (len(lead) + 1))
    lidx = torch.where(routed.mask, routed.ids - base, n_loc).clamp(0, n_loc)
    rv_pad = torch.cat([rv, rv.new_zeros(lead + (1, d))], dim=-2)
    resp = rv_pad.gather(-2, lidx.reshape(lead + (-1, 1)).long().expand(
        lead + (-1, d)))
    back = routing.reply(routed,
                         {"v": resp.reshape(routed.ids.shape + (d,))}, ctx)
    back = back["v"]  # (W, [Q,] R, D), one row per unique destination

    # --- expand to all requests: each request gathers its unique row ---
    idx = pos.gather(-1, dst.long().clamp(0, n_total - 1))
    idx = idx.long().clamp(0, max(r - 1, 0))
    per_req = back.gather(-2, idx[..., None].expand(lead + (r, d)))
    out = torch.where(valid[..., None], per_req, 0)
    return out, routed.overflow, remote


def _request_union(ctx: ChannelContext, dst, valid, rv, capacity):
    """Request/respond across the Q query lanes with ONE dedup and route
    pass over the union of the lanes' request sets. ``dst``/``valid`` are
    (W, R) or (W, Q, R), ``rv`` (W, Q, n_loc, D); lanes that are not live
    ask nothing. Returns (out (W, Q, R, D), overflow (W, Q), remote
    (W, Q)). Pure gathers: per lane bit-identical to the serial body
    whenever the union pass does not overflow (the overflow is
    conservative: union ranks dominate lane ranks)."""
    W, n_loc, q = ctx.num_workers, ctx.n_loc, ctx.num_queries
    R = ctx.rows  # the rows this process holds (W, or 1 on a rank)
    n_total = W * n_loc
    r, d, c = dst.shape[-1], rv.shape[-1], capacity
    routing._check_slot_range(W, c)
    dst_l, valid_l = routing.lane_views(ctx, dst, valid)  # (W, Q, R)
    dst_l = dst_l.to(torch.int32)

    # ---- union dedup: one compact entry per unique id ANY lane asks ----
    u_cap = min(q * r, n_total)
    u_dst, pos = routing.union_dedup(dst_l, valid_l, n_total, u_cap)
    u_valid = u_dst != routing.BIG
    seg_l = pos.gather(1, torch.clamp(dst_l.reshape(R, q * r).long(), 0,
                                      n_total - 1)).long().view(R, q, r)
    seg_l = torch.where(valid_l, seg_l, u_cap)  # (W, Q, R)
    # lane membership of each unique entry, one (u_cap, Q) matrix (the
    # dump column u_cap * Q, padded so that rows stay 16-byte aligned for
    # the route kernel, which reads them in place)
    col = seg_l * q + ctx.query_index()[None, :, None]
    col = torch.where(valid_l, col, u_cap * q).reshape(R, q * r)
    lanes = torch.zeros((R, u_cap * q + 16), dtype=torch.bool,
                        device=rv.device).scatter_(1, col, True)
    lanes = lanes[:, :u_cap * q].reshape(R, u_cap, q)

    # ---- ONE route pass over the union unique list ----
    owner = torch.clamp(u_dst // n_loc, 0, W - 1)
    key_u = torch.where(u_valid, owner, W).to(torch.int32)
    rank, _, lane_counts = routing.union_ranks(key_u, lanes, W)
    fits = rank < c
    slot = torch.where(u_valid & fits, key_u * c + rank, W * c)  # (W, u_cap)
    overflow = (lanes & ~fits[..., None]).any(dim=1)  # (W, Q)
    sent_l = torch.clamp(lane_counts, max=c)  # (W, W_dst, Q)
    me = ctx.me()
    remote = (sent_l.sum(dim=1) - ctx.workers.own(sent_l)).to(TRAFFIC_DTYPE)

    # ---- request wire: the shared unique ids, one exchange ----
    recv_ids = routing.exchange(ctx, routing.pack(
        slot, u_dst, W * c, routing.BIG).reshape(R, W, c))

    # ---- respond wire: a positional (slots, Q, D) lane matrix ----
    lidx = torch.where(recv_ids != routing.BIG,
                       recv_ids - (me * n_loc)[:, None, None], n_loc)
    rv_pad = torch.cat([rv, rv.new_zeros((R, q, 1, d))], dim=2)
    resp = rv_pad.gather(2, lidx.reshape(R, 1, W * c, 1).long().expand(
        R, q, W * c, d))  # (W_resp, Q, W_req * C, D)
    back = routing.exchange(
        ctx, resp.reshape(R, q, W, c, d).permute(0, 2, 3, 1, 4))
    flat = torch.cat([back.reshape(R, W * c, q, d),
                      back.new_zeros((R, 1, q, d))], dim=1)
    back_u = flat.gather(1, slot.long()[..., None, None].expand(
        R, u_cap, q, d))  # (W, u_cap, Q, D)

    # ---- each lane gathers its own requests' unique rows ----
    idx_l = torch.clamp(seg_l, 0, max(u_cap - 1, 0))
    per_req = back_u.permute(0, 2, 1, 3).gather(
        2, idx_l[..., None].expand(R, q, r, d))  # (W, Q, R, D)
    out = torch.where(valid_l[..., None], per_req, 0)
    return out, overflow, remote


@traced_channel
def request(
    ctx: ChannelContext,
    dst: torch.Tensor,
    valid: torch.Tensor,
    respond_vals: torch.Tensor,
    capacity: int,
    *,
    name: str = "request_respond",
):
    """Request ``respond_vals[dst]`` for each valid request.

    Args:
      dst: (W, R) int32 global ids to query.
      valid: (W, R) bool.
      respond_vals: (W, n_loc) or (W, n_loc, D) — the per-vertex
        attribute the responders expose.
      capacity: per-peer unique-request capacity.
    Under the batched query plane ``respond_vals`` is (W, Q, n_loc[, D]),
    ``dst``/``valid`` (W, R) or (W, Q, R), and every result gains Q after
    W (traffic per lane).
    Returns:
      (resp (W, R[, D]), overflow (W,)) — responses aligned with ``dst``
      (zeros for invalid requests).
    """
    squeeze = respond_vals.dim() == (3 if ctx.batched else 2)
    rv = respond_vals[..., None] if squeeze else respond_vals
    d = rv.shape[-1]
    capacity = ctx.scale_capacity(name + "/request", capacity)
    if ctx.batched and routing.resolve_batch() == "union":
        out, overflow, remote = _request_union(ctx, dst, valid, rv, capacity)
    else:  # solo, or each lane's serial body
        out, overflow, remote = _request_core(ctx, dst, valid, rv, capacity)
    ctx.add_traffic(name + "/request", remote * 4, remote)
    ctx.add_traffic(name + "/respond", remote * (d * rv.element_size()),
                    remote)
    ctx.add_overflow(name + "/request", overflow)
    return (out[..., 0] if squeeze else out), overflow
