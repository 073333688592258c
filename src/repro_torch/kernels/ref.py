"""Plain PyTorch versions of the port's CUDA kernels: the CPU path and
the oracle every kernel is held to on the card."""
from __future__ import annotations

import math

import torch

from repro_torch.core import combiners as cb


def segment_combine_ref(vals, seg_ids, num_segments, combiner):
    """Segment reduction oracle.

    Args:
      vals: ``(*B, E, *F)`` values.
      seg_ids: ``(*B, E)`` integer segment per value; ids outside
        ``[0, num_segments)`` are dropped.
      num_segments: N, output rows per batch row.
      combiner: Combiner or name.
    Returns:
      ``(*B, N, *F)``; empty segments hold the identity.
    """
    return cb.get(combiner).segment_reduce(vals, seg_ids, num_segments)


def bucket_ranks_ref(keys, num_buckets: int):
    """Stable counting-rank oracle for the bucket-route kernel.

    Args:
      keys: ``(*B, M)`` int32 bucket per message in ``[0, num_buckets]``;
        ``num_buckets`` itself is the invalid sentinel (still ranked).
      num_buckets: B (the worker count W).
    Returns:
      ``(rank (*B, M) int32, counts (*B, B) int32)``: the stable arrival
      rank of each key within its bucket along the last axis, and the
      occupancy of the real buckets. A key outside ``[0, num_buckets]``
      gets rank 0 and no count, as in the Pallas kernel.

    O(M·B) work, one masked prefix count per bucket.
    """
    keys = keys.to(torch.int32)
    rank = torch.zeros_like(keys)
    counts = []
    for b in range(num_buckets + 1):
        hit = keys == b
        rank = torch.where(
            hit, torch.cumsum(hit, dim=-1, dtype=torch.int32) - 1, rank)
        if b < num_buckets:
            counts.append(hit.sum(dim=-1, dtype=torch.int32))
    return rank, torch.stack(counts, dim=-1)


def bucket_ranks_lanes_ref(keys, lanes, num_buckets: int):
    """Oracle for the union-frontier bucket route: the shared ranks and
    occupancy of :func:`bucket_ranks_ref` plus each lane's per-bucket
    membership histogram.

    Args:
      keys: ``(*B, M)`` int32 bucket per union entry in
        ``[0, num_buckets]`` (``num_buckets`` = the invalid sentinel).
      lanes: ``(*B, M, Q)`` bool (or 0/1) lane membership; rows of
        sentinel entries must be all-False.
      num_buckets: B (the worker count W).
    Returns:
      ``(rank (*B, M), counts (*B, B), lane_counts (*B, B, Q))`` int32;
      ``lane_counts[..., b, q]`` counts lane q's entries in bucket b (the
      sentinel bucket, and keys outside ``[0, num_buckets]``, are
      dropped).
    """
    rank, counts = bucket_ranks_ref(keys, num_buckets)
    batch, m, q = tuple(keys.shape[:-1]), keys.shape[-1], lanes.shape[-1]
    rows, nb = math.prod(batch), num_buckets + 1
    k = keys.reshape(rows, m).long()
    k = torch.where((k >= 0) & (k < num_buckets), k, num_buckets)
    idx = (torch.arange(rows, device=k.device)[:, None] * nb + k).reshape(-1)
    hist = torch.zeros((rows * nb, q), dtype=torch.int32, device=k.device)
    hist.index_add_(0, idx, lanes.reshape(rows * m, q).to(torch.int32))
    lane_counts = hist.reshape(rows, nb, q)[:, :num_buckets]
    return rank, counts, lane_counts.reshape(batch + (num_buckets, q))
