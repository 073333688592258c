"""Kernel dispatch: the entry points the channels call.

Every wrapper decides by where its input lies, never by a fallback:

  - a CPU tensor takes the plain PyTorch version (``kernels/ref.py``) —
    there is no kernel to run on the host;
  - a CUDA tensor launches the hand-written CUDA kernel, or raises.
    ``use_kernel=None`` or ``True`` means the kernel; ``use_kernel=False``
    with a CUDA tensor is refused, so the plain version can never stand
    in for a kernel on the card unnoticed.

Each kernel keeps an integer launch count (:func:`launch_counts`), so a
run can show that its main path went through the kernels. The wrapper
adds one where it launches. A superstep loop captured into a CUDA graph
(the ``fused`` and ``chunked`` modes) launches its kernels by replaying
the graph, without the wrappers, and a kernel inside an inner loop's
WHILE node as often as the loop runs. So the kernels also count their
own launches on the device (:func:`device_launch_counts`, one atomic add
a launch, replays included), and the runtime adds what they counted
during its replays with :func:`add_replayed`: the counts read the same
in every mode. ``chip_smoke.py`` holds every mode's launches to the
host run's wrapper counts.

:func:`segment_reduce` is the channels' reduction over *unsorted* ids:
the combiners whose result depends on the order of the combines (float
``sum``, ``prod``, ``min_by_first``) go through a stable sort and the
``segment_combine`` kernel on the card, so they use no float atomics and
two runs are bit-identical; the rest are exact in any order and stay on
the plain scatter reduction.
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


#: launches made by replays of captured superstep loops, per kernel
_replayed: Dict[str, int] = {"bucket_ranks": 0, "bucket_ranks_lanes": 0,
                             "segment_combine": 0}


def wrapper_launch_counts() -> Dict[str, int]:
    """Launches the wrappers made (or captured) since the last reset."""
    return {"bucket_ranks": kbucket.launches,
            "bucket_ranks_lanes": kbucket.lane_launches,
            "segment_combine": kseg.launches}


def set_wrapper_launch_counts(counts: Dict[str, int]) -> None:
    """Put the wrappers' counts back to ``counts`` (what
    :func:`wrapper_launch_counts` gave): the runtime takes back the calls
    of a warm-up step and of a capture, which are no superstep of a run."""
    kbucket.launches = counts["bucket_ranks"]
    kbucket.lane_launches = counts["bucket_ranks_lanes"]
    kseg.launches = counts["segment_combine"]


def add_replayed(launched: Dict[str, int]) -> None:
    """Count the launches ``launched`` of each kernel that replays of a
    captured graph made (as :func:`device_launch_counts` differ across
    them); keys that are no wrapper's are ignored."""
    for name in _replayed:
        _replayed[name] += launched.get(name, 0)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`: the
    wrappers' and the replayed ones."""
    return {k: v + _replayed[k] for k, v in wrapper_launch_counts().items()}


def device_launch_counts() -> Dict[str, int]:
    """Launches since the kernels' libraries loaded, as the kernels count
    them on the device (one atomic add a launch), so launches replayed
    from a captured CUDA graph count too; ``segment_combine_join`` counts
    the second kernel of each ``segment_combine`` call. Synchronizes the
    device; loads (and on first use builds) the libraries."""
    ranks, lanes = kbucket.device_launches()
    tile, join = kseg.device_launches()
    return {"bucket_ranks": ranks, "bucket_ranks_lanes": lanes,
            "segment_combine": tile, "segment_combine_join": join}


def reset_launch_counts() -> None:
    set_wrapper_launch_counts(dict.fromkeys(_replayed, 0))
    for name in _replayed:
        _replayed[name] = 0


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


def order_sensitive(combiner, dtype: torch.dtype) -> bool:
    """Whether a segment reduction with ``combiner`` over ``dtype`` values
    can round or choose differently with the order of its combines."""
    name = cb.get(combiner).name
    return (name in ("prod", "min_by_first")
            or (name == "sum" and dtype.is_floating_point))


def segment_reduce(vals, seg_ids, num_segments: int, combiner, *,
                   use_kernel: Optional[bool] = None):
    """``Combiner.segment_reduce`` over unsorted ids, as the channels call
    it. On the card an order-sensitive combiner (:func:`order_sensitive`)
    stable-sorts the ids along their last axis, gathers the values into
    that order and launches the ``segment_combine`` kernel — the JAX
    reference's argsort and sorted scan; ``use_kernel=False`` raises
    there. Every other case is the plain reduction."""
    combiner = cb.get(combiner)
    if not (order_sensitive(combiner, vals.dtype)
            and _launches_kernel(vals, use_kernel, "segment_reduce")):
        return combiner.segment_reduce(vals, seg_ids, num_segments)
    seg, order = torch.sort(seg_ids, dim=-1, stable=True)
    idx = order.reshape(order.shape + (1,) * (vals.dim() - seg_ids.dim()))
    sorted_vals = vals.gather(seg_ids.dim() - 1, idx.expand_as(vals))
    return kseg.segment_combine_cuda(sorted_vals, seg, num_segments,
                                     combiner)


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
