"""Shared building blocks for the vertex-centric algorithms.

The port of ``repro.algorithms.common``, as far as the S-V, pointer-
jumping and Boruvka programs need it:

  - ``direct_request_respond``: the *baseline* request/respond — two
    DirectMessage rounds, ids on both wires, no dedup — what Pregel does
    without the request-respond channel; tagged requests (one per edge)
    and a padded ``wire_width`` serve the monolithic Boruvka;
  - ``pj_converge``: pointer jumping to a fixpoint over RequestRespond or
    the DirectMessage baseline, and ``jump_component``, the same as a
    composition-stack component;
  - ``cm_propagate``: the baseline label propagation that the Propagation
    channel replaces, one CombinedMessage superstep an iteration.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import combiners as cb
from repro_torch.core import compose
from repro_torch.core import message as msg
from repro_torch.core import request_respond as rr
from repro_torch.core.channel import (TRAFFIC_DTYPE, ChannelContext,
                                      inner_loop, on_device)


def direct_request_respond(
    ctx: ChannelContext,
    dst: torch.Tensor,
    valid: torch.Tensor,
    respond_vals: torch.Tensor,
    *,
    name: str = "basic_reqresp",
    wire_width: Optional[int] = None,
    tags: Optional[torch.Tensor] = None,
):
    """Baseline request-respond: requests via DirectMessage, the
    responder replies to each request individually via DirectMessage (ids
    on both wires, no dedup).

    dst: (W, R) requested global ids. Without ``tags``, R must be n_loc
    and request i is made by local vertex i: the reply routes back by
    that vertex's id. With ``tags`` ((R,) or (W, R), unique per worker,
    below R — e.g. one request per edge) the requester is the worker's
    first vertex and the tag rides both wires; the reply lands on row
    ``tag``.
    respond_vals: (W, n_loc[, D]) attribute exposed by every vertex.
    wire_width: payload bytes charged per message (default: the
      payload's own width).
    Returns (resp (W, R[, D]), overflow (W,)).
    """
    w, n_loc = ctx.rows, ctx.n_loc
    squeeze = respond_vals.dim() == 2
    rv = respond_vals[..., None] if squeeze else respond_vals
    d = rv.shape[-1]
    r = dst.shape[1]
    me = ctx.me()[:, None]
    payload = {}
    if tags is None:
        if r != n_loc:
            raise ValueError(
                f"direct_request_respond without tags takes one request "
                f"per local vertex ({n_loc}), got {r}")
        payload["requester"] = (me * n_loc + torch.arange(
            n_loc, device=dst.device)).to(torch.int32)
    else:
        # the reply routes to any of our vertices; the tag does the matching
        payload["requester"] = (me * n_loc).expand(w, r).to(torch.int32)
        payload["tag"] = on_device(tags, dst.device, torch.int32).expand(
            w, r)

    # phase 1: requests carry the requester id (and tag) — no dedup
    deliv = msg.direct_send(ctx, dst, valid, payload, capacity=r,
                            name=name + "/request", wire_width=wire_width)
    # phase 2: respond to each request individually
    rv_pad = torch.cat([rv, rv.new_zeros((w, 1, d))], dim=1)
    at = deliv.dst_local.long().clamp(0, n_loc)
    back_payload = {"v": rv_pad.gather(1, at[..., None].expand(-1, -1, d))}
    if tags is not None:
        back_payload["tag"] = deliv.payload["tag"]
    back = msg.direct_send(ctx, deliv.payload["requester"], deliv.mask,
                           back_payload, capacity=r, name=name + "/respond",
                           wire_width=wire_width)
    # each reply lands on its requester's row or its tag's (a dump row
    # for the rest)
    where = back.dst_local if tags is None else back.payload["tag"]
    slot = torch.where(back.mask, where, r).long()
    vals = torch.where(back.mask[..., None], back.payload["v"], 0)
    out = rv.new_zeros((w, r + 1, d))
    out.scatter_(1, slot[..., None].expand(-1, -1, d), vals)
    out = out[:, :r]
    overflow = deliv.overflow | back.overflow
    return (out[..., 0] if squeeze else out), overflow


def _sum_traffic(tmp: ChannelContext, nb, nm):
    """``nb``/``nm`` plus every key's traffic in ``tmp``, per worker."""
    for key in tmp.stats_bytes:
        nb = nb + tmp.stats_bytes[key]
        nm = nm + tmp.stats_msgs[key]
    return nb, nm


def pj_converge(ctx: ChannelContext, parents: torch.Tensor,
                mask: torch.Tensor, *, use_reqresp: bool = True,
                max_iters: int = 64, name: str = "pj_loop",
                wire_width: Optional[int] = None):
    """Pointer-jump ``parents`` (W, n_loc) to a fixpoint (all point to
    their root) over the RequestRespond channel, or with
    ``use_reqresp=False`` over the DirectMessage baseline
    (:func:`direct_request_respond`, ``wire_width`` bytes a message).

    An inner loop (:func:`~repro_torch.core.channel.inner_loop`): each
    round requests the grandparents in a fresh registry-free context; the
    loop stops when nothing changed or after ``max_iters`` rounds. The
    traffic of every round, the last (unchanged) one included, is summed
    per worker in int32 and charged once under ``name``, as the JAX
    package's ``while_loop`` carries it. Returns (roots, rounds): rounds
    a Python int in host mode, a 0-d int32 tensor in the device modes.
    """
    n_loc = ctx.n_loc

    def body(carry):
        p, _, rounds, nb, nm = carry
        tmp = ChannelContext(ctx.num_workers, n_loc, ctx.device,
                             device_loop=ctx.device_loop,
                             workers=ctx.workers)
        if use_reqresp:
            grand, _ = rr.request(tmp, p, mask, p, capacity=n_loc, name="x")
        else:
            grand, _ = direct_request_respond(tmp, p, mask, p, name="x",
                                              wire_width=wire_width)
        newp = torch.where(mask, grand, p)
        nb, nm = _sum_traffic(tmp, nb, nm)
        return newp, ctx.workers.any(newp != p), rounds + 1, nb, nm

    nb = torch.zeros(ctx.rows, dtype=TRAFFIC_DTYPE, device=ctx.device)
    p, _, rounds, nb, nm = inner_loop(
        ctx, lambda c: c[1] & (c[2] < max_iters), body,
        (parents, True, 0, nb, torch.zeros_like(nb)))
    ctx.add_traffic(name, nb, nm)
    return p, rounds


def cm_propagate(ctx: ChannelContext, raw_edges, init: torch.Tensor,
                 combiner_name: str, *, active0: torch.Tensor,
                 update=None, max_iters: int = 100_000,
                 name: str = "basic_propagation"):
    """Baseline label propagation: one CombinedMessage superstep per
    iteration until global convergence (what the Propagation channel
    replaces; O(diameter) global iterations).

    ``init`` is (W, n_loc) labels, ``active0`` the (W, n_loc) vertices
    that send in the first iteration; later, a vertex sends iff its label
    changed. ``update(lab, inc, got)`` gives the new labels (default: the
    combiner of ``lab`` and ``inc``). An inner loop in the style of
    :func:`pj_converge`: each iteration sends in a fresh registry-free
    context (the partition's ``route_cap`` copied) and the loop stops
    when no label changed or after ``max_iters`` iterations; the traffic
    of every iteration is summed per worker in int32 and charged once
    under ``name``. Returns (labels, iterations), as :func:`pj_converge`
    returns its rounds.
    """
    comb = cb.get(combiner_name)
    n_loc = ctx.n_loc
    upd = update or (lambda lab, inc, got: comb.fn(lab, inc))
    src = raw_edges.src_local.long()

    def body(carry):
        lab, active, _, iters, nb, nm = carry
        tmp = ChannelContext(ctx.num_workers, n_loc, ctx.device,
                             route_cap=ctx.route_cap,
                             device_loop=ctx.device_loop,
                             workers=ctx.workers)
        valid = raw_edges.mask & active.gather(1, src)
        inc, got, _ = msg.combined_send(
            tmp, raw_edges.dst_global, valid, lab.gather(1, src), comb,
            capacity=tmp.edge_capacity(n_loc), name="x")
        new = upd(lab, inc, got)
        active = new != lab
        nb, nm = _sum_traffic(tmp, nb, nm)
        return new, active, ctx.workers.any(active), iters + 1, nb, nm

    nb = torch.zeros(ctx.rows, dtype=TRAFFIC_DTYPE, device=ctx.device)
    lab, _, _, iters, nb, nm = inner_loop(
        ctx, lambda c: c[2] & (c[3] < max_iters), body,
        (init, active0, True, 0, nb, torch.zeros_like(nb)))
    ctx.add_traffic(name, nb, nm)
    return lab, iters


def jump_component() -> compose.Component:
    """:func:`pj_converge` as a composition-stack component — the
    full-jumping stage of the composed S-V (args ``(parents, mask)``, one
    stat key)."""

    def fn(ctx, name, parents, mask):
        return pj_converge(ctx, parents, mask, name=name)

    return compose.Component(fn)
