"""Plain PyTorch versions of the port's CUDA kernels: the CPU path and
the oracle every kernel is held to on the card."""
from __future__ import annotations

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
      occupancy of the real buckets.

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
