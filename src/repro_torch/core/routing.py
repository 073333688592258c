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

Under the batched query plane the routed channels share one route pass
across the Q query lanes: ``union_dedup`` compacts the union of every
lane's destinations and ``union_ranks`` ranks it once, with each lane's
per-owner occupancy (the ``bucket_ranks_lanes`` kernel on the card). The
JAX package reaches the same functions from inside its query ``vmap``
through ``custom_vmap``; here Q is an explicit dim.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core.channel import TRAFFIC_DTYPE
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
    buffers at ``slot`` (W, M); slots >= width land in a dump column."""
    w, m = slot.shape
    rest = tuple(leaf.shape[2:])
    buf = torch.full((w * (width + 1),) + rest, fill, dtype=leaf.dtype,
                     device=leaf.device)
    rows = torch.arange(w, device=slot.device)[:, None] * (width + 1)
    idx = rows + slot.long().clamp(0, width)
    buf[idx.reshape(-1)] = leaf.reshape((w * m,) + rest)
    return buf.reshape((w, width + 1) + rest)[:, :width]


def exchange(buf: torch.Tensor) -> torch.Tensor:
    """The tiled ``all_to_all``: worker q's block for peer p becomes
    worker p's block from peer q — ``(W_src, W_dst, ...)`` to
    ``(W_dst, W_src, ...)``."""
    return buf.transpose(0, 1).contiguous()


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
      dst: (W, M) int32 global destination ids.
      valid: (W, M) bool.
      payload: dict of (W, M, ...) tensors (may be empty).
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
    ids = torch.where(valid, dst.to(torch.int32), BIG)
    owner = torch.clamp(ids // n_loc, 0, W - 1)
    key = torch.where(valid, owner, W).to(torch.int32)

    if impl == "bucket":
        rank, count = kops.bucket_ranks(key, W, use_kernel=use_kernel)
    else:
        rank, count = _slots_sort(key, W)

    fits = rank < c
    overflow = (valid & ~fits).any(dim=1)
    slot = torch.where(valid & fits, key * c + rank, W * c)
    # wire accounting: only packed messages cross the wire
    sent_count = torch.clamp(count, max=c)

    recv_ids = exchange(pack(slot, ids, W * c, BIG).reshape(W, W, c))
    recv_payload = None
    if exchange_payload:
        recv_payload = {
            k: exchange(pack(slot, leaf, W * c, 0).reshape(
                (W, W, c) + tuple(leaf.shape[2:])))
            for k, leaf in payload.items()}
    return Routed(ids=recv_ids, mask=recv_ids != BIG, payload=recv_payload,
                  slot=slot, sent_count=sent_count, overflow=overflow)


def reply(routed: Routed, resp: Dict[str, torch.Tensor]):
    """Send per-slot responses back positionally (no ids on the wire) and
    deliver them in the original message order.

    Args:
      routed: the ``Routed`` of the request phase.
      resp: dict of ``(W_resp, W_req, C, ...)`` responses aligned with
        ``routed.ids`` (``[p, q]`` answers the block that q sent to p).
    Returns:
      dict of ``(W, M, ...)`` responses in each requester's original
      message order; messages that were never packed (``slot == W * C``)
      read a zero pad row.
    """
    out = {}
    for k, leaf in resp.items():
        back = exchange(leaf)  # [q, p] = p's answers to q's block
        w, rest = back.shape[0], tuple(back.shape[3:])
        flat = back.reshape((w, -1) + rest)
        flat = torch.cat([flat, flat.new_zeros((w, 1) + rest)], dim=1)
        idx = routed.slot.long().reshape(routed.slot.shape + (1,) * len(rest))
        out[k] = flat.gather(1, idx.expand(routed.slot.shape + rest))
    return out


def remote_count(ctx, sent_count: torch.Tensor) -> torch.Tensor:
    """(W,) wire messages that cross a worker boundary (exclude self)."""
    me = ctx.me()
    return (sent_count.sum(dim=1) - sent_count[me, me]).to(TRAFFIC_DTYPE)


def dedup_dense(dst: torch.Tensor, valid: torch.Tensor, n_total: int,
                m_cap: Optional[int] = None):
    """Sort-free per-worker dedup: the compact ascending list of unique
    valid destinations, via a dense occupancy histogram + prefix-sum
    compaction (see the JAX package's ``dedup_dense``).

    Args:
      dst: (W, M) int32 global destination ids.
      valid: (W, M) bool.
      n_total: id-space bound (W * n_loc).
      m_cap: compact-list capacity (default M).
    Returns:
      ``(u_dst (W, m_cap) ascending, BIG-padded; pos (W, n_total) int32
      compact index of each id, arbitrary where the id never occurs)``.
    """
    w, m = dst.shape
    m_cap = m if m_cap is None else m_cap
    key = torch.where(valid, dst.to(torch.int32), n_total).long()
    got = torch.zeros((w, n_total + 1), dtype=torch.bool, device=dst.device)
    got.scatter_(1, key, True)
    got = got[:, :n_total]
    pos = torch.cumsum(got, dim=1, dtype=torch.int32) - 1
    ids = torch.arange(n_total, dtype=torch.int32, device=dst.device)
    u_dst = pack(torch.where(got, pos, m_cap), ids.expand(w, n_total),
                 m_cap, BIG)
    return u_dst, pos


# ---------------------------------------------------------------------------
# union-frontier batched routing (the query-aware data plane)
# ---------------------------------------------------------------------------


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
