"""Dynamic message routing — the exchange beneath the paper's standard
message channels (Table I).

The port of ``repro.core.routing``, with the W workers as the leading
dim of every tensor. Messages are (destination-global-id, payload) pairs
with a validity mask; ownership is by contiguous id range, so each
message's wire slot is ``owner * C + rank`` (rank = stable arrival rank
within the owner bucket). Each worker packs a ``(W_dst, C, ...)`` buffer
by scattering into its slots, and the JAX tiled ``all_to_all`` over the
worker axis becomes a transpose of the ``(W_src, W_dst, C, ...)`` stack.

Two implementations compute the ranks, bit-identical in every
``Routed`` field:

  - ``"bucket"`` (default): one-pass counting ranks — the
    ``bucket_ranks`` CUDA kernel on the card, its plain version on the
    host (``repro_torch.kernels.ops.bucket_ranks``);
  - ``"sort"``: the stable-``argsort`` baseline, on host tensors only
    (on the card it would stand in for the kernel unnoticed).

Out-of-range scatter slots (dropped or overflowing messages) go to a
dump column that is cut off: JAX drops them (``mode="drop"``), PyTorch
would raise or fault.

RequestRespond answers along the same slots: :func:`reply` runs the
exchange in the other direction and gathers each answer back to its
original message through ``Routed.slot`` — no ids on the respond wire.

Traffic accounting contract: ``sent_count`` counts *wire* messages —
valid entries actually packed into a peer's capacity-bounded block.
Enqueued sends beyond the capacity latch ``overflow`` but are never
charged.

Under the batched query plane (``route_batch="union"``, the default) the
routed channels share one route pass across the Q query lanes:
``union_dedup`` compacts the union of every lane's destinations and
``union_ranks`` ranks it once, with each lane's per-owner occupancy (the
``bucket_ranks_lanes`` kernel on the card); :func:`route_union` is the
DirectMessage form. ``route_batch="lane"`` is the measured baseline: Q
independent route passes, one a lane — :func:`route`, :func:`reply`,
:func:`dedup_dense` and :func:`remote_count` take a lane dim after W
(``(W, Q, M)``) and then run one pass a lane in one launch. The JAX
package reaches the same functions from inside its query ``vmap``
through ``custom_vmap`` and its ``in_batched`` flags; here Q is an
explicit dim, and a tensor's shape says whether it varies by lane.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from repro_torch.configs import knobs
from repro_torch.core.channel import TRAFFIC_DTYPE
from repro_torch.distributed.workers import LocalWorkers
from repro_torch.kernels import ops as kops
from repro_torch.pregel.errors import PlanRangeError

BIG = torch.iinfo(torch.int32).max

IMPLS = ("bucket", "sort")


def _check_slot_range(w: int, capacity: int) -> None:
    """Wire slots are int32 ``owner * C + rank``: past int32 the id
    silently wraps into another worker's range."""
    if w * capacity > BIG:
        raise PlanRangeError(
            f"routed exchange W * capacity = {w} * {capacity} exceeds the "
            f"int32 wire-slot range ({BIG}); reduce the per-peer capacity "
            "(e.g. a partition-derived ChannelContext.edge_capacity bound) "
            "or the worker count.",
            channels=("route",),
        )


@dataclasses.dataclass
class Routed:
    """Result of a routed exchange, for all W workers."""

    ids: torch.Tensor          # (W, W, C) int32 global dst ids received (BIG pad)
    mask: torch.Tensor         # (W, W, C) bool
    payload: Optional[Dict[str, torch.Tensor]]  # leaves (W, W, C, ...)
    slot: torch.Tensor         # (W, M) wire slot per original message (W*C = dropped)
    sent_count: torch.Tensor   # (W, W) wire messages packed per peer
    overflow: torch.Tensor     # (W,) bool — capacity exceeded
    # with a lane dim (per-lane passes, route_union): every field gains Q
    # after W — ids (W, Q, W, C), slot (W, Q, M), sent_count (W, Q, W),
    # overflow (W, Q)


def _slots_sort(key: torch.Tensor, w: int):
    """Baseline: stable argsort over owners, rank by position, per row.
    Same (rank, count) contract as ``kops.bucket_ranks``."""
    rows, m = key.shape
    skey, order = torch.sort(key, dim=1, stable=True)
    edges = torch.arange(w + 1, dtype=torch.int32, device=key.device)
    bounds = torch.searchsorted(
        skey, edges.expand(rows, w + 1).contiguous(), side="left"
    ).to(torch.int32)
    pos = torch.arange(m, dtype=torch.int32, device=key.device)
    rank_sorted = pos - bounds.gather(1, skey.clamp(max=w - 1).long())
    rank = torch.zeros_like(key).scatter_(1, order, rank_sorted)
    return rank, bounds[:, 1:] - bounds[:, :-1]


def pack(slot: torch.Tensor, leaf: torch.Tensor, width: int, fill):
    """Scatter ``leaf`` (W, M, ...) into per-worker ``(W, width, ...)``
    buffers at ``slot`` (W, M); slots >= width land in a dump column.
    ``slot`` may carry a lane dim, (W, Q, M) with ``leaf`` (W, Q, M, ...):
    one buffer a worker and lane."""
    lead, m = tuple(slot.shape[:-1]), slot.shape[-1]
    rows = math.prod(lead)
    rest = tuple(leaf.shape[slot.dim():])
    buf = torch.full((rows * (width + 1),) + rest, fill, dtype=leaf.dtype,
                     device=leaf.device)
    base = torch.arange(rows, device=slot.device)[:, None] * (width + 1)
    idx = base + slot.reshape(rows, m).long().clamp(0, width)
    buf[idx.reshape(-1)] = leaf.reshape((rows * m,) + rest)
    return buf.reshape(lead + (width + 1,) + rest).narrow(len(lead), 0,
                                                          width)


def exchange(ctx, buf: torch.Tensor, peer_dim: int = 1) -> torch.Tensor:
    """The tiled ``all_to_all`` of ``ctx``'s workers layer (all workers
    in this process when ``ctx`` is None): worker q's block for peer p
    becomes worker p's block from peer q — ``(W_src, W_dst, ...)`` to
    ``(W_dst, W_src, ...)``; with a lane dim between them, ``(W_src, Q,
    W_dst, ...)`` to ``(W_dst, Q, W_src, ...)`` (``peer_dim=2``). On a
    rank of a group the leading dim is the rank's one row."""
    workers = (LocalWorkers(buf.shape[peer_dim]) if ctx is None
               else ctx.workers)
    return workers.exchange(buf, peer_dim)


def route(
    ctx,
    dst: torch.Tensor,
    valid: torch.Tensor,
    payload: Dict[str, torch.Tensor],
    capacity: int,
    *,
    exchange_payload: bool = True,
    impl: str = "bucket",
    use_kernel: Optional[bool] = None,
) -> Routed:
    """Route messages to the owners of their destination vertices.

    Args:
      ctx: ChannelContext (W/n_loc).
      dst: (W, M) int32 global destination ids, or (W, Q, M): Q
        independent routes, one a query lane, in one pass (the per-lane
        route of ``route_batch="lane"``).
      valid: bool, the shape of ``dst``.
      payload: dict of (W, M, ...) tensors ((W, Q, M, ...) with lanes;
        may be empty).
      capacity: per-peer slot capacity C.
      impl: "bucket" (the kernel on the card) or "sort" (the baseline,
        CPU tensors only).
      use_kernel: see ``repro_torch.kernels.ops``.
    """
    if impl not in IMPLS:
        raise ValueError(f"route impl {impl!r} not in {IMPLS}")
    if impl == "sort" and dst.is_cuda:
        raise ValueError(
            'route: impl="sort" with a CUDA tensor — the sort baseline runs '
            "only on the CPU; the card routes through the bucket_ranks kernel")
    W, n_loc = ctx.num_workers, ctx.n_loc
    c = capacity
    _check_slot_range(W, c)
    lead = tuple(dst.shape[:-1])  # (W,) or (W, Q)
    ids = torch.where(valid, dst.to(torch.int32), BIG)
    owner = torch.clamp(ids // n_loc, 0, W - 1)
    key = torch.where(valid, owner, W).to(torch.int32)

    if impl == "bucket":
        rank, count = kops.bucket_ranks(key, W, use_kernel=use_kernel)
    else:
        rank, count = _slots_sort(key.reshape(-1, key.shape[-1]), W)
        rank, count = rank.reshape(key.shape), count.reshape(lead + (W,))

    fits = rank < c
    overflow = (valid & ~fits).any(dim=-1)
    slot = torch.where(valid & fits, key * c + rank, W * c)
    # wire accounting: only packed messages cross the wire
    sent_count = torch.clamp(count, max=c)

    peer = len(lead)

    def wire(leaf, fill):
        buf = pack(slot, leaf, W * c, fill)
        rest = tuple(buf.shape[peer + 1:])
        return exchange(ctx, buf.reshape(lead + (W, c) + rest), peer)

    recv_ids = wire(ids, BIG)
    recv_payload = None
    if exchange_payload:
        recv_payload = {k: wire(leaf, 0) for k, leaf in payload.items()}
    return Routed(ids=recv_ids, mask=recv_ids != BIG, payload=recv_payload,
                  slot=slot, sent_count=sent_count, overflow=overflow)


def reply(routed: Routed, resp: Dict[str, torch.Tensor], ctx=None):
    """Send per-slot responses back positionally (no ids on the wire) and
    deliver them in the original message order.

    Args:
      routed: the ``Routed`` of the request phase.
      resp: dict of ``(W_resp, W_req, C, ...)`` responses aligned with
        ``routed.ids`` (``[p, q]`` answers the block that q sent to p);
        ``(W_resp, Q, W_req, C, ...)`` when the route had lanes.
      ctx: the route's ChannelContext, whose workers layer runs the
        exchange (None: all workers in this process).
    Returns:
      dict of ``(W, M, ...)`` (with lanes ``(W, Q, M, ...)``) responses
      in each requester's original message order; messages that were
      never packed (``slot == W * C``) read a zero pad row.
    """
    peer = routed.slot.dim() - 1
    out = {}
    for k, leaf in resp.items():
        back = exchange(ctx, leaf, peer)  # [q, .., p] = p's answers to q's block
        lead, rest = tuple(back.shape[:peer]), tuple(back.shape[peer + 2:])
        flat = back.reshape(lead + (-1,) + rest)
        flat = torch.cat([flat, flat.new_zeros(lead + (1,) + rest)], dim=peer)
        idx = routed.slot.long().reshape(routed.slot.shape + (1,) * len(rest))
        out[k] = flat.gather(peer, idx.expand(routed.slot.shape + rest))
    return out


def remote_count(ctx, sent_count: torch.Tensor) -> torch.Tensor:
    """(W,) wire messages that cross a worker boundary (exclude self);
    (W, Q) from a per-lane ``sent_count`` (W, Q, W)."""
    own = ctx.workers.own(sent_count.movedim(-1, 1))
    return (sent_count.sum(dim=-1) - own).to(TRAFFIC_DTYPE)


def dedup_dense(dst: torch.Tensor, valid: torch.Tensor, n_total: int,
                m_cap: Optional[int] = None):
    """Sort-free per-worker dedup: the compact ascending list of unique
    valid destinations, via a dense occupancy histogram + prefix-sum
    compaction (see the JAX package's ``dedup_dense``).

    Args:
      dst: (W, M) int32 global destination ids, or (W, Q, M): one dedup
        a worker and lane.
      valid: bool, the shape of ``dst``.
      n_total: id-space bound (W * n_loc).
      m_cap: compact-list capacity (default M).
    Returns:
      ``(u_dst (W, m_cap) ascending, BIG-padded; pos (W, n_total) int32
      compact index of each id, arbitrary where the id never occurs)``,
      each with the lane dim of ``dst``.
    """
    lead, m = tuple(dst.shape[:-1]), dst.shape[-1]
    rows = math.prod(lead)
    m_cap = m if m_cap is None else m_cap
    key = torch.where(valid, dst.to(torch.int32), n_total).long()
    got = torch.zeros((rows, n_total + 1), dtype=torch.bool,
                      device=dst.device)
    got.scatter_(1, key.reshape(rows, m), True)
    got = got[:, :n_total]
    pos = torch.cumsum(got, dim=1, dtype=torch.int32) - 1
    ids = torch.arange(n_total, dtype=torch.int32, device=dst.device)
    u_dst = pack(torch.where(got, pos, m_cap), ids.expand(rows, n_total),
                 m_cap, BIG)
    return (u_dst.reshape(lead + (m_cap,)),
            pos.reshape(lead + (n_total,)))


# ---------------------------------------------------------------------------
# union-frontier batched routing (the query-aware data plane)
# ---------------------------------------------------------------------------

BATCH_IMPLS = ("union", "lane")

#: the batched-routing strategy knob (explicit > batch_scope >
#: REPRO_ROUTE_BATCH > "union")
ROUTE_BATCH = knobs.Knob(
    "route_batch", env="REPRO_ROUTE_BATCH", default="union",
    choices=BATCH_IMPLS, describe="route batch strategy")


def resolve_batch(batch: Optional[str] = None) -> str:
    """The batched-routing strategy for a call site: explicit argument,
    else the :func:`batch_scope` override, else ``REPRO_ROUTE_BATCH``,
    else ``"union"``.

      - ``"union"`` (default): per superstep, the routed channels compute
        the union frontier across the Q query lanes and run ONE
        bucket-route pass over it; payloads travel as a ``(slots, Q)``
        lane matrix with per-lane membership masks.
      - ``"lane"``: Q independent route passes a superstep, each lane's
        serial body (the JAX package's query ``vmap`` of the serial
        route) — the measured baseline.
    """
    return ROUTE_BATCH.resolve(batch)


def batch_scope(batch: Optional[str]):
    """Pin the batched-routing strategy for every routed channel under
    the scope — how ``Engine(route_batch=...)`` threads the knob through
    a run (and, on the card, through the capture of its loop)."""
    return ROUTE_BATCH.scope(batch)


def lane_views(ctx, dst: torch.Tensor, valid: torch.Tensor):
    """``dst`` and ``valid`` of a batched send, each (W, M) (the same for
    every lane) or (W, Q, M), as ``(W, Q, M)`` views, with the lanes that
    are not live (:func:`lane_live`) masked out of ``valid``."""
    def per_lane(x):
        if x.dim() == 3:
            return x
        return x[:, None].expand(x.shape[0], ctx.num_queries, x.shape[1])

    live = lane_live(ctx)[None, :, None]
    return per_lane(dst), per_lane(valid) & live


def lane_live(ctx) -> torch.Tensor:
    """(Q,) per-lane liveness for the batched channels: the runtime's
    pre-step halt vote, or all True when none was given (e.g. a context
    built by hand in a test)."""
    if ctx.query_live is None:
        return torch.ones(ctx.num_queries, dtype=torch.bool,
                          device=ctx.device)
    return ctx.query_live.to(torch.bool)


def union_dedup(dst_l: torch.Tensor, valid_l: torch.Tensor, n_total: int,
                u_cap: int):
    """:func:`dedup_dense` across Q lanes at once: per worker, the compact
    ascending list of the UNION of every lane's valid destinations.

    Args:
      dst_l: (W, Q, M) int32 global destination ids per lane.
      valid_l: (W, Q, M) bool.
      n_total: id-space bound (W * n_loc).
      u_cap: compact-list capacity — ``min(Q * M, n_total)`` never
        truncates (the union cannot exceed either bound).
    Returns:
      ``(u_dst (W, u_cap) ascending, BIG-padded; pos (W, n_total) int32
      compact index of each id)``.
    """
    w = dst_l.shape[0]
    return dedup_dense(dst_l.reshape(w, -1), valid_l.reshape(w, -1),
                       n_total, u_cap)


def union_ranks(key: torch.Tensor, lanes: torch.Tensor, w: int, *,
                use_kernel: Optional[bool] = None):
    """Shared ranks plus per-lane per-owner counts over a union key list —
    the one route pass of the batched data plane. ``key`` (W, U) int32
    owners (``w`` = invalid), ``lanes`` (W, U, Q) bool membership.
    Returns ``(rank (W, U), count (W, W), lane_counts (W, W, Q))``; as in
    :func:`route` there is no sort baseline on the card."""
    return kops.bucket_ranks_lanes(key, lanes, w, use_kernel=use_kernel)


def route_union(
    ctx,
    dst: torch.Tensor,
    valid: torch.Tensor,
    payload: Dict[str, torch.Tensor],
    capacity: int,
    *,
    exchange_payload: bool = True,
    use_kernel: Optional[bool] = None,
) -> Routed:
    """Batched :func:`route`: one shared bucket-route pass over the union
    frontier of all Q query lanes. Outside the batched query plane this
    IS ``route``.

    Args:
      dst: (W, M) lane-invariant destinations (graph topology), or
        (W, Q, M) when they vary by lane.
      valid: (W, M) or (W, Q, M); a lane that is not live
        (:func:`lane_live`) sends nothing.
      payload: dict of (W, Q, M, ...) per-lane leaves.
    Returns:
      the per-lane ``Routed`` view of the shared exchange (every field
      with Q after W), per lane what a serial route of that lane gives
      whenever the union pass does not overflow.

    Positional union slots are only sound when ``dst`` is lane-invariant;
    a lane-varying ``dst`` falls back to Q per-lane route passes (the
    same results, no sharing). Overflow is conservative (union ranks
    dominate lane ranks: a lane may overflow where its solo route would
    not, never the reverse); the sent counts are each lane's exact ones.
    """
    if not ctx.batched:
        return route(ctx, dst, valid, payload, capacity,
                     exchange_payload=exchange_payload, use_kernel=use_kernel)
    W, n_loc, q = ctx.num_workers, ctx.n_loc, ctx.num_queries
    c = capacity
    _check_slot_range(W, c)
    dst_l, valid_l = lane_views(ctx, dst, valid)
    if dst.dim() == 3:  # dst varies by lane: Q per-lane passes
        return route(ctx, dst_l, valid_l, payload, c,
                     exchange_payload=exchange_payload, use_kernel=use_kernel)

    # ---- one shared pass over the union frontier ----
    rows = dst.shape[0]
    uvalid = valid_l.any(dim=1)  # (W, M)
    ids = torch.where(uvalid, dst.to(torch.int32), BIG)
    owner = torch.clamp(ids // n_loc, 0, W - 1)
    key = torch.where(uvalid, owner, W).to(torch.int32)
    lanes = valid_l.transpose(1, 2).contiguous()  # (W, M, Q)
    rank, _, lane_counts = union_ranks(key, lanes, W, use_kernel=use_kernel)
    fits = rank < c
    packed = uvalid & fits
    slot = torch.where(packed, key * c + rank, W * c)  # (W, M) shared
    # per-lane views of the shared pass
    overflow = (valid_l & ~fits[:, None]).any(dim=-1)  # (W, Q)
    sent = torch.clamp(lane_counts, max=c).transpose(1, 2)  # (W, Q, W)
    slot_l = torch.where(valid_l & packed[:, None], slot[:, None], W * c)

    recv_ids = exchange(ctx, pack(slot, ids, W * c, BIG).reshape(
        rows, W, c))
    # per-lane wire membership rides as one (slots, Q) lane matrix
    recv_mask = exchange(ctx, pack(slot, lanes, W * c, False).reshape(
        rows, W, c, q)).permute(0, 3, 1, 2)  # (W, Q, W_src, C)
    # a lane's ids view pads the slots it did not occupy (= serial view)
    out_ids = torch.where(recv_mask, recv_ids[:, None], BIG)
    recv_payload = None
    if exchange_payload:
        recv_payload = {}
        for k, leaf in payload.items():  # (W, Q, M, ...)
            rest = tuple(leaf.shape[3:])
            leaf_t = leaf.movedim(1, 2)  # (W, M, Q, ...)
            sel = lanes.reshape(lanes.shape + (1,) * len(rest))
            leaf_t = torch.where(sel, leaf_t, 0)  # the serial pack fill
            buf = pack(slot, leaf_t, W * c, 0).reshape((rows, W, c, q)
                                                       + rest)
            recv_payload[k] = exchange(ctx, buf).movedim(3, 1)
    return Routed(ids=out_ids, mask=recv_mask, payload=recv_payload,
                  slot=slot_l, sent_count=sent, overflow=overflow)
