"""Kernel dispatch: the entry points the channels call.

Every wrapper decides by where its input lies, never by a fallback:

  - a CPU tensor takes the plain PyTorch version (``kernels/ref.py``) —
    there is no kernel to run on the host;
  - a CUDA tensor launches the hand-written CUDA kernel, or raises.
    ``use_kernel=None`` or ``True`` means the kernel; ``use_kernel=False``
    with a CUDA tensor is refused, so the plain version can never stand
    in for a kernel on the card unnoticed.

Each kernel keeps an integer launch count (:func:`launch_counts`), so a
run can show that its main path went through the kernels.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import combiners as cb
from repro_torch.kernels import bucket_route as kbucket
from repro_torch.kernels import ref as kref
from repro_torch.kernels import segment_combine as kseg


def _launches_kernel(x: torch.Tensor, use_kernel: Optional[bool],
                     what: str) -> bool:
    if not x.is_cuda:
        return False
    if use_kernel is False:
        raise ValueError(
            f"{what}: use_kernel=False with a CUDA tensor — the plain "
            "version runs only on the CPU; pass a CPU tensor for it")
    return True


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {"bucket_ranks": kbucket.launches,
            "bucket_ranks_lanes": kbucket.lane_launches,
            "segment_combine": kseg.launches}


def reset_launch_counts() -> None:
    kbucket.launches = 0
    kbucket.lane_launches = 0
    kseg.launches = 0


def segment_combine(vals, seg_ids, num_segments: int, combiner, *,
                    use_kernel: Optional[bool] = None):
    """``out[..., s, :] = combine(vals[..., e, :] for seg_ids[..., e] == s)``
    over the last axis of ``seg_ids``; ids outside ``[0, num_segments)``
    are dropped and empty segments hold the identity. The ids must be
    sorted along their last axis: the kernel reads each segment as one
    contiguous range."""
    combiner = cb.get(combiner)
    if _launches_kernel(vals, use_kernel, "segment_combine"):
        return kseg.segment_combine_cuda(vals, seg_ids, num_segments,
                                         combiner)
    return kref.segment_combine_ref(vals, seg_ids, num_segments, combiner)


def bucket_ranks(keys, num_buckets: int, *,
                 use_kernel: Optional[bool] = None):
    """Stable arrival rank of each key within its bucket along the last
    axis, plus the per-bucket occupancy — the permutation core of the
    routed exchange (see ``repro_torch.core.routing``).

    Args:
      keys: ``(*B, M)`` int32 bucket per message in ``[0, num_buckets]``
        where ``num_buckets`` is the invalid sentinel.
      num_buckets: the bucket count (the worker count W).
    Returns:
      ``(rank (*B, M) int32, counts (*B, num_buckets) int32)``.
    """
    if _launches_kernel(keys, use_kernel, "bucket_ranks"):
        return kbucket.bucket_ranks_cuda(keys, num_buckets)
    return kref.bucket_ranks_ref(keys, num_buckets)


def bucket_ranks_lanes(keys, lanes, num_buckets: int, *,
                       use_kernel: Optional[bool] = None):
    """:func:`bucket_ranks` over a union key list plus each query lane's
    per-bucket membership histogram, in one pass — the route pass of the
    batched query plane (see ``repro_torch.core.routing.union_ranks``).

    Args:
      keys: ``(*B, M)`` int32 bucket per union entry in
        ``[0, num_buckets]`` (``num_buckets`` = the invalid sentinel).
      lanes: ``(*B, M, Q)`` bool lane membership, all-False on sentinel
        rows.
      num_buckets: the bucket count (the worker count W).
    Returns:
      ``(rank (*B, M), counts (*B, num_buckets), lane_counts (*B,
      num_buckets, Q))`` int32.
    """
    if _launches_kernel(keys, use_kernel, "bucket_ranks_lanes"):
        return kbucket.bucket_ranks_lanes_cuda(keys, lanes, num_buckets)
    return kref.bucket_ranks_lanes_ref(keys, lanes, num_buckets)
