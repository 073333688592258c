"""Scatter-Combine channel (paper §IV-C1).

The port of ``repro.core.scatter_combine``. The static messaging
pattern: every vertex sends a value to all of its neighbors, every
superstep. The plan sorts the edges by destination once, so a superstep
is: gather → sorted-segment combine (the ``segment_combine`` CUDA kernel
on the card) → one exchange with **no vertex ids on the wire** →
receive-side combine. The receive side is a sorted segment combine too:
the plan carries a stable host-side sort of ``recv_local``
(``recv_order``/``recv_sorted``), so it runs through the same kernel and
two runs on the card give bit-identical results (no float atomics).

Under the batched query plane the Q lanes ride as columns: values
``(W, Q, n_loc[, D])`` become ``(W, n_loc, Q·D)``, so a superstep is one
gather, one send-side and one receive-side ``segment_combine`` launch
over ``Q·D`` columns (the segment ids read once an entry) and one
exchange of the ``(W, W, C, Q, D)`` payload. The kernel's combine order
depends only on entry positions, so each column equals the ``D = 1``
solo call bit for bit. The traffic is the plan's static remote count for
each live lane, 0 for the others.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import combiners as cb
from repro_torch.core import compose
from repro_torch.core.channel import (TRAFFIC_DTYPE, ChannelContext,
                                      traced_channel)
from repro_torch.core.routing import lane_live, pack
from repro_torch.graph.pgraph import ScatterPlan
from repro_torch.kernels import ops as kops


def plan_broadcast_combine(
    ctx: ChannelContext,
    plan: ScatterPlan,
    vertex_vals: torch.Tensor,
    combiner,
    *,
    edge_transform: Optional[Callable] = None,
    use_kernel: Optional[bool] = None,
    name: str = "scatter_combine",
) -> compose.PlannedExchange:
    """Stage one scatter-combine superstep up to (not including) the
    exchange; see :func:`broadcast_combine` for the arguments. Returns a
    ``PlannedExchange`` whose payload is the packed positional
    ``(W, W, C, D)`` send buffer (batched ``(W, W, C, Q, D)``) and whose
    ``finish`` does the receive-side combine."""
    combiner = cb.get(combiner)
    w, c = ctx.num_workers, plan.slot_cap
    rows = ctx.rows
    squeeze = vertex_vals.dim() == (3 if ctx.batched else 2)
    vals = vertex_vals[..., None] if squeeze else vertex_vals
    d = vals.shape[-1]  # the payload width of one lane
    lanes = ()
    if ctx.batched:  # the lanes as columns: (W, n_loc, Q·D)
        lanes = (vals.shape[1],)
        vals = vals.movedim(1, 2).reshape(rows, ctx.n_loc, -1)
    cols = vals.shape[-1]
    ident = combiner.ident_for(vals.dtype)

    # 1. per-edge values, gathered by local src. Mirrored plans extend the
    # gather space with every worker's exported-hub values (index
    # n_loc + owner * hub_cap + hub_rank): the static all_gather of the
    # (hub_cap, D) hub tables, charged below under this channel.
    mirror_msgs = torch.zeros(rows, dtype=TRAFFIC_DTYPE, device=vals.device)
    if plan.hub_cap:
        exported = plan.hub_local < ctx.n_loc  # (W, hub_cap) real slots
        safe = torch.clamp(plan.hub_local.long(), max=ctx.n_loc - 1)
        mine = torch.where(
            exported[..., None],
            vals.gather(1, safe[..., None].expand(-1, -1, cols)),
            ident)  # (W, hub_cap, Q·D)
        hubs = ctx.workers.gather(mine).reshape(1, -1, cols).expand(
            rows, -1, cols)  # all_gather
        vals_ext = torch.cat([vals, hubs], dim=1)
        mirror_msgs = (exported.sum(dim=1) * (w - 1)).to(TRAFFIC_DTYPE)
    else:
        vals_ext = vals
    src = plan.edge_src.long()[..., None].expand(-1, -1, cols)
    per_edge = vals_ext.gather(1, src)  # (W, E_cap, Q·D)
    if edge_transform is not None:
        per_edge = edge_transform(per_edge, plan.edge_w)

    # 2. sender-side combine: one value per unique destination (sorted
    # segment ids by construction; pad edges carry u_cap and drop)
    u_vals = kops.segment_combine(per_edge, plan.edge_seg, plan.u_cap,
                                  combiner, use_kernel=use_kernel)

    # 3. positional pack (payload only — the routing is static)
    send = pack(plan.pack_slot, u_vals, w * c, ident).reshape(
        (rows, w, c) + lanes + (d,))

    # 4. (deferred) receive-side combine into dense per-vertex values
    def finish(recv):
        flat = recv["v"].reshape(rows, w * c, cols)
        order = plan.recv_order.long()[..., None].expand(-1, -1, cols)
        out = kops.segment_combine(flat.gather(1, order), plan.recv_sorted,
                                   ctx.n_loc, combiner, use_kernel=use_kernel)
        if lanes:  # (W, n_loc, Q·D) -> (W, Q, n_loc, D)
            out = out.reshape((rows, ctx.n_loc) + lanes + (d,)).movedim(2, 1)
        return out[..., 0] if squeeze else out

    remote = (plan.send_count.sum(dim=1)
              - ctx.workers.own(plan.send_count)).to(TRAFFIC_DTYPE)
    remote = remote + mirror_msgs  # hub broadcast crosses (W-1) boundaries
    if lanes:  # each live lane sends the plan's messages
        remote = torch.where(lane_live(ctx), remote[:, None], 0).to(
            TRAFFIC_DTYPE)
    return compose.PlannedExchange(
        name=name,
        payload={"v": send},
        finish=finish,
        nbytes=remote * (d * vals.element_size()),
        nmsgs=remote,
    )


@traced_channel
def broadcast_combine(
    ctx: ChannelContext,
    plan: ScatterPlan,
    vertex_vals: torch.Tensor,
    combiner,
    *,
    edge_transform: Optional[Callable] = None,
    use_kernel: Optional[bool] = None,
    name: str = "scatter_combine",
) -> torch.Tensor:
    """One scatter-combine superstep.

    Args:
      plan: the graph's ScatterPlan (all W workers).
      vertex_vals: (W, n_loc) or (W, n_loc, D) per-vertex value to
        broadcast; (W, Q, n_loc[, D]) under the batched query plane.
      combiner: Combiner (a vertex receives the combine over its
        in-neighbors).
      edge_transform: optional fn(per_edge_vals, edge_w) -> per_edge_vals
        (per_edge_vals (W, E, D); batched (W, E, Q·D), the lanes'
        columns side by side).
      use_kernel: see ``repro_torch.kernels.ops`` (None = the kernel on
        the card).
    Returns:
      (W, n_loc) or (W, n_loc, D) combined incoming value per vertex
      (combiner identity where nothing arrived); batched (W, Q, n_loc[,
      D]).
    """
    planned = plan_broadcast_combine(
        ctx, plan, vertex_vals, combiner,
        edge_transform=edge_transform, use_kernel=use_kernel, name=name,
    )
    (out,) = compose.fused_exchange(ctx, [planned])
    return out
