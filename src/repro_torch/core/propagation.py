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
                                      inner_loop)
from repro_torch.core.routing import exchange, pack
from repro_torch.graph.pgraph import PropPlan
from repro_torch.kernels import ops as kops


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
      init_vals: (W, n_loc) or (W, n_loc, D) initial labels.
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
    Returns:
      (labels, outer rounds, local iterations (W,) int32 summed over the
      rounds). The rounds are a Python int in host mode and a 0-d int32
      tensor in the device modes, as the JAX ``while_loop`` returns them.
    """
    if ctx.batched:
        raise NotImplementedError(
            "the Propagation channel under the batched query plane is not "
            "ported yet (see ROADMAP: batched sssp:prop)")
    combiner = cb.get(combiner)
    squeeze = init_vals.dim() == 2
    lab = init_vals[..., None] if squeeze else init_vals
    d, dtype = lab.shape[-1], lab.dtype
    ident = combiner.ident_for(dtype)
    cut = plan.cut
    w, c, n_loc = ctx.num_workers, cut.slot_cap, ctx.n_loc
    dev = lab.device
    upd = update or combiner.fn
    srcv = src_values or (lambda x: x)

    def index(idx):  # (W, E) plan table -> int64 (W, E, D) gather index
        return idx.long()[..., None].expand(-1, -1, d)

    # converted once a call, not once an iteration
    int_src, edge_src, recv_order = (
        index(x) for x in (plan.int_src, cut.edge_src, cut.recv_order))

    def changed_rows(new, old):  # (W,) any change per worker
        return (new != old).reshape(w, -1).any(dim=1)

    def local_fixpoint(lab):
        # per worker: iterate while its labels change, at most max_inner
        # times; a converged worker keeps its carry (the vmapped loop)
        def body(carry):
            lab, active, iters = carry
            pe = srcv(lab).gather(1, int_src)
            if edge_transform is not None:
                pe = edge_transform(pe, plan.int_w)
            inc = kops.segment_combine(pe, plan.int_dst, n_loc, combiner)
            new = upd(lab, inc)
            changed = changed_rows(new, lab)
            lab = torch.where(active[:, None, None], new, lab)
            iters = iters + active.to(torch.int32)
            return lab, active & changed & (iters < max_inner), iters

        active = torch.full((w,), max_inner > 0, dtype=torch.bool,
                            device=dev)
        iters = torch.zeros(w, dtype=torch.int32, device=dev)
        lab, _, iters = inner_loop(ctx, lambda c: c[1].any(), body,
                                   (lab, active, iters))
        return lab, iters

    # owner of each unique cut destination (W = padding)
    u_owner = torch.where(cut.pack_slot < w * c, cut.pack_slot // c, w)
    remote_u = (u_owner != w) & (u_owner != ctx.me()[:, None])

    # mirrored cut plans: edge_src indexes local values followed by every
    # worker's exported-hub values, refreshed by one all_gather an
    # exchange; only hubs whose value changed count as traffic
    if cut.hub_cap:
        exported = cut.hub_local < n_loc  # (W, hub_cap)
        hub_safe = index(torch.clamp(cut.hub_local, max=n_loc - 1))

    def cut_edge_vals(lab, prev_hub):
        base = srcv(lab)
        changed_h = torch.zeros(w, dtype=TRAFFIC_DTYPE, device=dev)
        mine = prev_hub
        if cut.hub_cap:
            mine = torch.where(exported[..., None], base.gather(1, hub_safe),
                               ident)  # (W, hub_cap, D)
            hubs = mine.reshape(1, -1, d).expand(w, -1, d)  # all_gather
            base = torch.cat([base, hubs], dim=1)
            changed_h = ((mine != prev_hub).any(dim=-1) & exported).sum(
                dim=1).to(TRAFFIC_DTYPE)
        pe = base.gather(1, edge_src)
        if edge_transform is not None:
            pe = edge_transform(pe, cut.edge_w)
        return pe, mine, changed_h

    width = d * lab.element_size()

    def round_(carry):
        lab, prev_u, prev_hub, nbytes, nmsgs, iters, rounds, _ = carry
        lab, it = local_fixpoint(lab)

        # cut exchange: scatter-combine over the cut edges, changed-only
        # traffic
        pe, prev_hub_next, changed_h = cut_edge_vals(lab, prev_hub)
        u_vals = kops.segment_combine(pe, cut.edge_seg, cut.u_cap, combiner)
        remote_changed = ((u_vals != prev_u).any(dim=-1) & remote_u).sum(
            dim=1).to(TRAFFIC_DTYPE)
        recv = exchange(pack(cut.pack_slot, u_vals, w * c, ident).reshape(
            w, w, c, d)).reshape(w, w * c, d)
        inc = kops.segment_combine(recv.gather(1, recv_order),
                                   cut.recv_sorted, n_loc, combiner)
        new = upd(lab, inc)
        delta = remote_changed + changed_h * (w - 1)
        return (new, u_vals, prev_hub_next, nbytes + delta * width,
                nmsgs + delta, iters + it, rounds + 1,
                changed_rows(new, lab).any())

    prev_u = torch.full((w, cut.u_cap, d), ident, dtype=dtype, device=dev)
    prev_hub = torch.full((w, cut.hub_cap, d), ident, dtype=dtype,
                          device=dev)
    nbytes = torch.zeros(w, dtype=TRAFFIC_DTYPE, device=dev)
    iters = torch.zeros(w, dtype=torch.int32, device=dev)
    lab, _, _, nbytes, nmsgs, iters, rounds, _ = inner_loop(
        ctx, lambda c: c[7] & (c[6] < max_outer), round_,
        (lab, prev_u, prev_hub, nbytes, torch.zeros_like(nbytes), iters, 0,
         True))
    ctx.add_traffic(name, nbytes, nmsgs)
    return (lab[..., 0] if squeeze else lab), rounds, iters
