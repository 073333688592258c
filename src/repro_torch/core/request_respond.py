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

Under the batched query plane the JAX package shares one route pass
across the Q lanes (``_request_union`` over ``route_union``), which is
not ported yet: a batched request raises.
"""
from __future__ import annotations

import torch

from repro_torch.core import routing
from repro_torch.core.channel import ChannelContext


def _request_core(ctx: ChannelContext, dst, valid, rv, capacity):
    """The request/respond body over all W workers. ``rv`` is
    (W, n_loc, D). Returns (out (W, R, D), overflow (W,), remote (W,));
    traffic is charged by the caller."""
    w, r = dst.shape
    n_loc, d = ctx.n_loc, rv.shape[-1]
    n_total = w * n_loc

    # --- dedup: one compact entry per unique destination (sort-free) ---
    u_dst, pos = routing.dedup_dense(dst, valid, n_total)
    u_valid = u_dst != routing.BIG

    # --- request phase: ids only ---
    routed = routing.route(ctx, u_dst, u_valid, {}, capacity)
    remote = routing.remote_count(ctx, routed.sent_count)

    # --- respond phase: positional values, no ids ---
    base = (ctx.me() * n_loc)[:, None, None]
    lidx = torch.where(routed.mask, routed.ids - base, n_loc).clamp(0, n_loc)
    rv_pad = torch.cat([rv, rv.new_zeros((w, 1, d))], dim=1)
    resp = rv_pad.gather(1, lidx.reshape(w, -1, 1).long().expand(-1, -1, d))
    back = routing.reply(routed, {"v": resp.reshape(routed.ids.shape + (d,))})
    back = back["v"]  # (W, R, D), one row per unique destination

    # --- expand to all requests: each request gathers its unique row ---
    idx = pos.gather(1, dst.long().clamp(0, n_total - 1))
    idx = idx.long().clamp(0, max(r - 1, 0))
    per_req = back.gather(1, idx[..., None].expand(-1, -1, d))
    out = torch.where(valid[..., None], per_req, 0)
    return out, routed.overflow, remote


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
    Returns:
      (resp (W, R[, D]), overflow (W,)) — responses aligned with ``dst``
      (zeros for invalid requests).
    """
    if ctx.batched:
        raise NotImplementedError(
            "RequestRespond under the batched query plane needs route_union, "
            "which is not ported yet (see ROADMAP)")
    squeeze = respond_vals.dim() == 2
    rv = respond_vals[..., None] if squeeze else respond_vals
    d = rv.shape[-1]
    capacity = ctx.scale_capacity(name + "/request", capacity)
    out, overflow, remote = _request_core(ctx, dst, valid, rv, capacity)
    ctx.add_traffic(name + "/request", remote * 4, remote)
    ctx.add_traffic(name + "/respond", remote * (d * rv.element_size()),
                    remote)
    ctx.add_overflow(name + "/request", overflow)
    return (out[..., 0] if squeeze else out), overflow
