"""The benchmark's frozen measures: peak rates, the bytes a kernel call
must move, seeded sub-streams, the superstep-clock arrivals and the
percentile and spread arithmetic.

Nothing here imports the program. The byte counts follow one rule: the
real entries' bytes, each input read once and each output written once,
whatever kernel implements the call.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence

import numpy as np

#: Published memory rate of each card, bytes a second (NVIDIA's data
#: sheet of the H100 SXM, at the full 700 W power limit). The kernels'
#: calls here move bytes and compute little, so bytes bound them.
HBM_BYTES_PER_S: Dict[str, float] = {"NVIDIA H100 80GB HBM3": 3.35e12}


def hbm_bytes_per_s(device_name: str) -> float:
    """The card's published memory rate; a card missing from the table
    has no roofline (raises KeyError)."""
    return HBM_BYTES_PER_S[device_name]


def substream(seed: int, *keys: int) -> int:
    """A 63-bit seed for one named stream of a run: the same ``seed`` and
    ``keys`` always give the same number, different keys unrelated ones.
    ``seed`` may be any non-negative integer, past 32 bits too."""
    ss = np.random.SeedSequence([int(seed), *[int(k) for k in keys]])
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


def poisson_arrivals(n: int, rate: float, seed: int,
                     order_seed: int) -> List[int]:
    """``n`` arrival times, in supersteps, of a Poisson process with
    ``rate`` expected arrivals a superstep: cumulative exponential gaps,
    floored to the superstep grid. The gaps are drawn from ``seed`` and
    put in an order drawn from ``order_seed``: schedules of one ``seed``
    span the same time and differ in their bursts (independent gaps in
    any order are still a Poisson process)."""
    if rate <= 0:
        raise ValueError(f"arrival rate must be positive, got {rate}")
    gaps = np.random.default_rng(seed).exponential(scale=1.0 / rate, size=n)
    gaps = np.random.default_rng(order_seed).permutation(gaps)
    return np.floor(np.cumsum(gaps)).astype(np.int64).tolist()


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between
    order statistics; an infinite value (a failed request) sorts last."""
    if not len(values):
        raise ValueError("percentile of no values")
    x = sorted(float(v) for v in values)
    h = (len(x) - 1) * q / 100.0
    lo = math.floor(h)
    hi = min(lo + 1, len(x) - 1)
    if h == lo or x[lo] == x[hi]:
        return x[lo]
    return x[lo] + (h - lo) * (x[hi] - x[lo])


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartile as a share of
    the median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def _real(ids, n: int) -> int:
    return int(((ids >= 0) & (ids < n)).sum())


def segment_combine_bytes(vals, seg_ids, num_segments: int) -> int:
    """``segment_combine(vals (*B, E, *F), seg_ids (*B, E), N)``: each
    real entry's id and its F values read once, the (*B, N, *F) output
    written once."""
    rows = math.prod(seg_ids.shape[:-1])
    feat = math.prod(vals.shape[seg_ids.dim():])
    real = _real(seg_ids, num_segments)
    return (real * (seg_ids.element_size() + feat * vals.element_size())
            + rows * num_segments * feat * vals.element_size())


def bucket_ranks_bytes(keys, num_buckets: int) -> int:
    """``bucket_ranks(keys (*B, M), B)``: every key read and every rank
    written (4 bytes each), the (*B, B) counts written."""
    rows = math.prod(keys.shape[:-1])
    return keys.numel() * 8 + rows * num_buckets * 4


def bucket_ranks_lanes_bytes(keys, lanes, num_buckets: int) -> int:
    """``bucket_ranks_lanes(keys (*B, M), lanes (*B, M, Q), B)``: every
    key read and rank written, the Q membership bytes of each real entry
    (a sentinel's are zero by contract), the (*B, B) counts and (*B, B,
    Q) lane counts written."""
    rows = math.prod(keys.shape[:-1])
    q = lanes.shape[-1]
    real = int((keys < num_buckets).sum())
    return (keys.numel() * 8 + real * q * lanes.element_size()
            + rows * num_buckets * (q + 1) * 4)


#: what each wrapped kernel entry point must move, by its name in
#: ``repro_torch.kernels.ops``; each takes the call's leading arguments
KERNEL_BYTES = {
    "segment_combine": segment_combine_bytes,
    "bucket_ranks": bucket_ranks_bytes,
    "bucket_ranks_lanes": bucket_ranks_lanes_bytes,
}
