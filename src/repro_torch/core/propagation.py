"""Propagation channel (paper §IV-C3).

The port of ``repro.core.propagation``. Label-propagation algorithms
converge in O(diameter) Pregel supersteps. This channel runs a *local
fixpoint* over partition-internal edges between global exchanges, so
the number of global rounds drops to about the diameter of the quotient
graph over partitions. Only values that changed since the last exchange
are counted as traffic (the buffer is dense and static; the accounting
counts the logical messages a sparse implementation would send, as the
paper counts them).

The JAX package runs two nested ``while_loop``s under ``vmap``. Here W is
the leading dim and both loops are inner loops
(``repro_torch.core.channel.inner_loop``): in host mode each iteration
ends in one readback of its continue flag; in the fused and chunked
modes the rounds are a WHILE node of the captured superstep and the
local fixpoint a WHILE node inside it. A worker whose local fixpoint has
converged keeps its labels and its iteration count while the others go
on, as under ``vmap``, so the per-worker iteration counts match the
reference's.

Under the batched query plane (``Engine.run_batch`` of ``sssp:prop``)
each of the Q lanes is its own fixpoint, as under the JAX package's
query ``vmap``: the lanes ride as the columns of every tensor (labels
``(W, n_loc, Q·D)``), so each combine is still one kernel launch, on Q·D
columns; each worker and lane has its own local-fixpoint freeze and
iteration count, each lane its own outer rounds, its own freeze (a lane
whose labels stopped changing keeps its carry while the others go on)
and its own ``(W, Q)`` traffic. A lane that is not live at the step
(a pad lane, or one that has halted) runs no round and charges nothing.
Both loops stay inner loops; their conditions are "any worker (and
lane) still going".

Every combine runs on ids that are sorted when the plan is built, so on
the card each is one ``segment_combine`` kernel launch with no sort at
run time: the fixpoint's ``int_dst``, the cut plan's ``edge_seg`` and,
on the receive side, ``recv_sorted`` after a gather by ``recv_order``.

The combiner h must be commutative and associative and the update
monotone (min/max-style) for the fixpoint to be order-insensitive — the
requirement the paper places on h.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import combiners as cb
from repro_torch.core.channel import (TRAFFIC_DTYPE, ChannelContext,
                                      inner_loop, traced_channel)
from repro_torch.core.routing import exchange, pack
from repro_torch.graph.pgraph import PropPlan
from repro_torch.kernels import ops as kops




@traced_channel
def propagate(
    ctx: ChannelContext,
    plan: PropPlan,
    init_vals: torch.Tensor,
    combiner,
    *,
    edge_transform: Optional[Callable] = None,
    update: Optional[Callable] = None,
    src_values: Optional[Callable] = None,
    max_inner: int = 10_000,
    max_outer: int = 10_000,
    name: str = "propagation",
):
    """Run propagation to global convergence.

    Args:
      init_vals: (W, n_loc) or (W, n_loc, D) initial labels; under the
        batched query plane (W, Q, n_loc) or (W, Q, n_loc, D).
      combiner: h — combines incoming neighbour values into the vertex
        value.
      edge_transform: fn(per_edge_vals (W, E, D), edge_w (W, E)) — f
        applied along an edge (e.g. ``lambda v, w: v + w[..., None]`` for
        SSSP).
      update: fn(lab, incoming) -> new lab, both (W, n_loc, D) (default:
        ``combiner(lab, inc)``).
      src_values: fn(lab) -> the (W, n_loc, D) value broadcast to
        out-neighbours (default: identity; used e.g. to mask frozen
        vertices).
      Batched, the three callbacks see the lanes as columns: (W, E, Q·D)
      and (W, n_loc, Q·D), lane-major, so they must act column by column.
    Returns:
      (labels, outer rounds, local iterations (W,) int32 summed over the
      rounds). The rounds are a Python int in host mode and a 0-d int32
      tensor in the device modes, as the JAX ``while_loop`` returns them.
      Batched: the rounds are (Q,) and the iterations (W, Q), each lane's
      own, and the traffic is added per lane, (W, Q).
    """
    combiner = cb.get(combiner)
    q = ctx.num_queries if ctx.batched else None
    lanes = q or 1
    rows = ctx.rows  # the rows this process holds (W, or 1 on a rank)
    squeeze = init_vals.dim() == (3 if q else 2)
    lab = init_vals[..., None] if squeeze else init_vals
    d, dtype = lab.shape[-1], lab.dtype
    if q:  # (W, Q, n_loc, D) -> the lanes as columns, (W, n_loc, Q·D)
        lab = lab.permute(0, 2, 1, 3).reshape(rows, -1, q * d)
    dq = lanes * d
    ident = combiner.ident_for(dtype)
    cut = plan.cut
    w, c, n_loc = ctx.num_workers, cut.slot_cap, ctx.n_loc
    dev = lab.device
    upd = update or combiner.fn
    srcv = src_values or (lambda x: x)

    def index(idx):  # (W, E) plan table -> int64 (W, E, Q·D) gather index
        return idx.long()[..., None].expand(-1, -1, dq)

    # converted once a call, not once an iteration
    int_src, edge_src, recv_order = (
        index(x) for x in (plan.int_src, cut.edge_src, cut.recv_order))

    def per_lane(x, n):  # (W, n, Q·D) -> (W, n, Q): any over D
        return x.reshape(rows, n, lanes, d).any(dim=-1)

    def cols(flags):  # (W, Q) lane flags -> a (W, 1, Q·D) column mask
        return flags[:, None, :, None].expand(rows, 1, lanes, d).reshape(
            rows, 1, dq)

    def changed_rows(new, old):  # (W, Q) any change per worker and lane
        return per_lane(new != old, n_loc).any(dim=1)

    def local_fixpoint(lab, going):
        # per worker and lane: iterate while its labels change, at most
        # max_inner times; a converged one keeps its carry (the vmapped
        # loop). ``going``: the (Q,) lanes of this round (None: all)
        def body(carry):
            lab, active, iters = carry
            pe = srcv(lab).gather(1, int_src)
            if edge_transform is not None:
                pe = edge_transform(pe, plan.int_w)
            inc = kops.segment_combine(pe, plan.int_dst, n_loc, combiner)
            new = upd(lab, inc)
            changed = changed_rows(new, lab)
            lab = torch.where(cols(active), new, lab)
            iters = iters + active.to(torch.int32)
            return lab, active & changed & (iters < max_inner), iters

        active = torch.full((rows, lanes), max_inner > 0, dtype=torch.bool,
                            device=dev)
        if going is not None:
            active = active & going
        iters = torch.zeros(rows, lanes, dtype=torch.int32, device=dev)
        # "any worker still going": on a group every rank runs every
        # iteration (a frozen worker keeps its carry), as the local loop
        lab, _, iters = inner_loop(ctx, lambda c: ctx.workers.any(c[1]),
                                   body, (lab, active, iters),
                                   name="propagation.local")
        return lab, iters

    # owner of each unique cut destination (W = padding)
    u_owner = torch.where(cut.pack_slot < w * c, cut.pack_slot // c, w)
    remote_u = ((u_owner != w) & (u_owner != ctx.me()[:, None]))[..., None]

    # mirrored cut plans: edge_src indexes local values followed by every
    # worker's exported-hub values, refreshed by one all_gather an
    # exchange; only hubs whose value changed count as traffic
    if cut.hub_cap:
        exported = cut.hub_local < n_loc  # (W, hub_cap)
        hub_safe = index(torch.clamp(cut.hub_local, max=n_loc - 1))

    def cut_edge_vals(lab, prev_hub):
        base = srcv(lab)
        changed_h = torch.zeros(rows, lanes, dtype=TRAFFIC_DTYPE,
                                device=dev)
        mine = prev_hub
        if cut.hub_cap:
            mine = torch.where(exported[..., None], base.gather(1, hub_safe),
                               ident)  # (W, hub_cap, Q·D)
            hubs = ctx.workers.gather(mine).reshape(1, -1, dq).expand(
                rows, -1, dq)  # all_gather
            base = torch.cat([base, hubs], dim=1)
            changed_h = (per_lane(mine != prev_hub, cut.hub_cap)
                         & exported[..., None]).sum(dim=1).to(TRAFFIC_DTYPE)
        pe = base.gather(1, edge_src)
        if edge_transform is not None:
            pe = edge_transform(pe, cut.edge_w)
        return pe, mine, changed_h

    width = d * lab.element_size()

    def round_(carry, going=None):
        lab, prev_u, prev_hub, nbytes, nmsgs, iters, rounds, _ = carry
        lab, it = local_fixpoint(lab, going)

        # cut exchange: scatter-combine over the cut edges, changed-only
        # traffic
        pe, prev_hub_next, changed_h = cut_edge_vals(lab, prev_hub)
        u_vals = kops.segment_combine(pe, cut.edge_seg, cut.u_cap, combiner)
        remote_changed = (per_lane(u_vals != prev_u, cut.u_cap)
                          & remote_u).sum(dim=1).to(TRAFFIC_DTYPE)
        recv = exchange(ctx, pack(cut.pack_slot, u_vals, w * c,
                                  ident).reshape(rows, w, c, dq)).reshape(
            rows, w * c, dq)
        inc = kops.segment_combine(recv.gather(1, recv_order),
                                   cut.recv_sorted, n_loc, combiner)
        new = upd(lab, inc)
        delta = remote_changed + changed_h * (w - 1)
        changed = ctx.workers.reduce(changed_rows(new, lab), cb.OR)[0]
        # (the psum, per lane)
        return (new, u_vals, prev_hub_next, nbytes + delta * width,
                nmsgs + delta, iters + it, rounds + 1,
                changed if q else changed.any())

    def lane_round(carry):
        # each lane its own fixpoint: a lane that has stopped keeps its
        # carry, as the vmapped while_loop selects it
        going = carry[7] & (carry[6] < max_outer)  # (Q,)
        new = round_(carry, going)
        g_cols = cols(going.expand(rows, q))
        g_wq = going.expand(rows, q)
        keep = (g_cols, g_cols, g_cols, g_wq, g_wq, g_wq, going, going)
        return tuple(torch.where(g, a, b)
                     for g, a, b in zip(keep, new, carry))

    prev_u = torch.full((rows, cut.u_cap, dq), ident, dtype=dtype,
                        device=dev)
    prev_hub = torch.full((rows, cut.hub_cap, dq), ident, dtype=dtype,
                          device=dev)
    nbytes = torch.zeros(rows, lanes, dtype=TRAFFIC_DTYPE, device=dev)
    iters = torch.zeros(rows, lanes, dtype=torch.int32, device=dev)
    if q:
        # pad lanes and lanes that have halted start stopped: they run no
        # round and charge nothing
        start = (torch.ones(q, dtype=torch.bool, device=dev)
                 if ctx.query_live is None else ctx.query_live.clone())
        carry = (lab, prev_u, prev_hub, nbytes, torch.zeros_like(nbytes),
                 iters, torch.zeros(q, dtype=torch.int32, device=dev), start)
        lab, _, _, nbytes, nmsgs, iters, rounds, _ = inner_loop(
            ctx, lambda c: (c[7] & (c[6] < max_outer)).any(), lane_round,
            carry, name="propagation.round")
        ctx.add_traffic(name, nbytes, nmsgs)
        lab = lab.reshape(rows, n_loc, q, d).permute(0, 2, 1,
                                                     3).contiguous()
        return (lab[..., 0] if squeeze else lab), rounds, iters
    lab, _, _, nbytes, nmsgs, iters, rounds, _ = inner_loop(
        ctx, lambda c: c[7] & (c[6] < max_outer), round_,
        (lab, prev_u, prev_hub, nbytes, torch.zeros_like(nbytes), iters, 0,
         True), name="propagation.round")
    ctx.add_traffic(name, nbytes[:, 0], nmsgs[:, 0])
    return (lab[..., 0] if squeeze else lab), rounds, iters[:, 0]
