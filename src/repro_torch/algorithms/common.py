"""Shared building blocks for the vertex-centric algorithms.

The port of ``repro.algorithms.common``, as far as the S-V and
pointer-jumping programs need it:

  - ``direct_request_respond``: the *baseline* request/respond — two
    DirectMessage rounds, ids on both wires, no dedup — what Pregel does
    without the request-respond channel;
  - ``pj_converge``: pointer jumping to a fixpoint, and
    ``jump_component``, the same as a composition-stack component.

The tagged requests, ``wire_width`` padding, the DirectMessage flavour
of ``pj_converge`` and ``cm_propagate`` come with the ``msf``/``prop``
slices (ROADMAP).
"""
from __future__ import annotations

import torch

from repro_torch.core import compose
from repro_torch.core import message as msg
from repro_torch.core import request_respond as rr
from repro_torch.core.channel import TRAFFIC_DTYPE, ChannelContext


def direct_request_respond(
    ctx: ChannelContext,
    dst: torch.Tensor,
    valid: torch.Tensor,
    respond_vals: torch.Tensor,
    *,
    name: str = "basic_reqresp",
):
    """Baseline request-respond: each local vertex i requests
    ``respond_vals[dst[:, i]]`` via DirectMessage (its own global id on
    the wire), and the responder replies to each request individually via
    DirectMessage, routed back by the requester's id.

    dst: (W, n_loc) requested global ids, one request per local vertex.
    respond_vals: (W, n_loc[, D]) attribute exposed by every vertex.
    Returns (resp (W, n_loc[, D]), overflow (W,)).
    """
    w, n_loc = ctx.num_workers, ctx.n_loc
    squeeze = respond_vals.dim() == 2
    rv = respond_vals[..., None] if squeeze else respond_vals
    d = rv.shape[-1]
    r = dst.shape[1]
    if r != n_loc:
        raise ValueError(
            f"direct_request_respond takes one request per local vertex "
            f"({n_loc}), got {r} (tagged requests are not ported yet)")
    requester = (ctx.me()[:, None] * n_loc
                 + torch.arange(n_loc, device=dst.device)).to(torch.int32)

    # phase 1: requests carry the requester id — no dedup
    deliv = msg.direct_send(ctx, dst, valid, {"requester": requester},
                            capacity=r, name=name + "/request")
    # phase 2: respond to each request individually
    rv_pad = torch.cat([rv, rv.new_zeros((w, 1, d))], dim=1)
    at = deliv.dst_local.long().clamp(0, n_loc)
    tgt_vals = rv_pad.gather(1, at[..., None].expand(-1, -1, d))
    back = msg.direct_send(ctx, deliv.payload["requester"], deliv.mask,
                           {"v": tgt_vals}, capacity=r,
                           name=name + "/respond")
    # each reply lands on its requester's row (a dump row for the rest)
    slot = torch.where(back.mask, back.dst_local, r).long()
    vals = torch.where(back.mask[..., None], back.payload["v"], 0)
    out = rv.new_zeros((w, r + 1, d))
    out.scatter_(1, slot[..., None].expand(-1, -1, d), vals)
    out = out[:, :r]
    overflow = deliv.overflow | back.overflow
    return (out[..., 0] if squeeze else out), overflow


def pj_converge(ctx: ChannelContext, parents: torch.Tensor,
                mask: torch.Tensor, *, max_iters: int = 64,
                name: str = "pj_loop"):
    """Pointer-jump ``parents`` (W, n_loc) to a fixpoint (all point to
    their root) over the RequestRespond channel.

    A host loop: each round requests the grandparents in a fresh
    registry-free context and reads back one ``changed`` flag; it stops
    when nothing changed or after ``max_iters`` rounds. The traffic of
    every round, the last (unchanged) one included, is summed per worker
    in int32 and charged once under ``name``, as the JAX package's
    ``while_loop`` carries it. Returns (roots, rounds).
    """
    w, n_loc = ctx.num_workers, ctx.n_loc
    nb = torch.zeros(w, dtype=TRAFFIC_DTYPE, device=ctx.device)
    nm = torch.zeros_like(nb)
    p, rounds, changed = parents, 0, True
    while changed and rounds < max_iters:
        tmp = ChannelContext(w, n_loc, ctx.device)
        grand, _ = rr.request(tmp, p, mask, p, capacity=n_loc, name="x")
        newp = torch.where(mask, grand, p)
        for key in tmp.stats_bytes:
            nb = nb + tmp.stats_bytes[key]
            nm = nm + tmp.stats_msgs[key]
        changed = bool((newp != p).any())
        p, rounds = newp, rounds + 1
    ctx.add_traffic(name, nb, nm)
    return p, rounds


def jump_component() -> compose.Component:
    """:func:`pj_converge` as a composition-stack component — the
    full-jumping stage of the composed S-V (args ``(parents, mask)``, one
    stat key)."""

    def fn(ctx, name, parents, mask):
        return pj_converge(ctx, parents, mask, name=name)

    return compose.Component(fn)
