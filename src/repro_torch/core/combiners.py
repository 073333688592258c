"""Combiners — associative/commutative reduction operators for channels
(paper Table I; the per-channel combiner parameter of every §IV-C channel).

The port of ``repro.core.combiners``. ``segment_reduce`` is the plain
PyTorch segment reduction every channel uses off the kernel path: ids
outside ``[0, num_segments)`` land in a dump row that is cut off (JAX
drops them silently; PyTorch would raise or fault on them). Empty ``or``
segments hold False, the identity — the JAX reference's ``segment_max``
cast gives True there (ROADMAP fault 3).

``min_by_first`` is Boruvka's lexicographic argmin over the trailing
dim: column 0 is the key, the rest ride along as payload. It reduces
through ``core.segmented`` after a stable sort of the ids, as the JAX
package does; on a key tie the later entry wins. Empty segments follow
``identity_like``: key +inf (INT32_MAX for ints), payload 0 (ROADMAP
fault 4). A NaN key is ordered, so that every evaluation order gives
the same answer: a NaN that opens its segment wins it, any other NaN
loses to every other entry — what folding the pairwise rule over the
segment in position order gives (ROADMAP fault 7: the JAX scan's answer
depends on its tree there).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import segmented
from repro_torch.distributed import workers

_SCATTER_REDUCE = {"min": "amin", "max": "amax", "or": "amax",
                   "prod": "prod"}


def _min_by_first(a, b):
    """The pairwise rule: ``a`` where ``a``'s key (trailing column 0) is
    ``<=`` ``b``'s, else ``b`` — a NaN key on either side gives ``b``."""
    return torch.where(a[..., :1] <= b[..., :1], a, b)


_PAIRWISE = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum,
             "or": torch.logical_or, "prod": torch.mul,
             "min_by_first": _min_by_first}


# the bits of +inf per float dtype, as the same-width signed int
_INF_BITS = {torch.float16: 0x7C00, torch.bfloat16: 0x7F80,
             torch.float32: 0x7F800000, torch.float64: 0x7FF0000000000000}


def _first_key_rank(key: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """int64 rank of each ``min_by_first`` key, ordered as the keys are,
    with -0.0 and 0.0 tied and no NaN: a float's sign-magnitude bits made
    monotone; a NaN key ranks below every key where ``starts`` (it opens
    its segment) and above every key elsewhere. Integer keys rank as
    themselves."""
    if not key.dtype.is_floating_point:
        return key.long()
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[key.element_size()]
    bits = key.contiguous().view(ints).long()
    mag = torch.iinfo(ints).max
    rank = torch.where(bits >= 0, bits, -(bits & mag))
    inf = _INF_BITS[key.dtype]
    nan = key != key
    rank = torch.where(nan & starts, -inf - 1, rank)
    return torch.where(nan & ~starts, inf + 1, rank)


@dataclasses.dataclass(frozen=True)
class Combiner:
    """An associative, commutative binary reduction with identity.

    Attributes:
      name: short tag ("sum" | "min" | "max" | "or" | "prod" |
        "min_by_first").
      identity: identity element (python scalar; cast to the value dtype).
    """

    name: str
    identity: float

    def ident_for(self, dtype: torch.dtype):
        integer = not dtype.is_floating_point and dtype != torch.bool
        if self.name in ("min", "min_by_first"):
            return torch.iinfo(dtype).max if integer else math.inf
        if self.name == "max":
            return torch.iinfo(dtype).min if integer else -math.inf
        return self.identity

    def fn(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The pairwise op (the JAX ``Combiner.fn``), elementwise."""
        return _PAIRWISE[self.name](a, b)

    def identity_like(self, x: torch.Tensor) -> torch.Tensor:
        """The identity shaped like ``x``; for ``min_by_first`` a zero
        payload behind the key's identity (trailing column 0)."""
        if self.name == "min_by_first":
            out = torch.zeros_like(x)
            out[..., 0] = self.ident_for(x.dtype)
            return out
        return torch.full_like(x, self.ident_for(x.dtype))

    def segment_reduce(self, vals: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
        """Segment reduction over the last axis of ``seg_ids``.

        Args:
          vals: ``(*B, E, *F)`` values.
          seg_ids: ``(*B, E)`` integer segment id per value, sorted or
            not; ids outside ``[0, num_segments)`` are dropped.
          num_segments: N, the number of output rows per batch row.
        Returns:
          ``(*B, N, *F)``; empty segments hold the identity
          (``identity_like``).
        """
        if self.name == "min_by_first":
            return self._reduce_by_first(vals, seg_ids, num_segments)
        batch, e = tuple(seg_ids.shape[:-1]), seg_ids.shape[-1]
        feat = tuple(vals.shape[seg_ids.dim():])
        r, n = math.prod(batch), num_segments
        work = vals.to(torch.int32) if self.name == "or" else vals
        src = work.reshape(r * e, -1)
        seg = seg_ids.reshape(r, e).long()
        seg = torch.where((seg >= 0) & (seg < n), seg, n)  # dump row n
        rows = torch.arange(r, device=seg.device)[:, None] * (n + 1)
        idx = (rows + seg).reshape(-1)
        out = torch.full((r * (n + 1), src.shape[1]),
                         self.ident_for(work.dtype), dtype=work.dtype,
                         device=vals.device)
        if self.name == "sum":
            out.index_add_(0, idx, src)
        else:
            out.scatter_reduce_(0, idx[:, None].expand_as(src), src,
                                _SCATTER_REDUCE[self.name], include_self=True)
        out = out.reshape(r, n + 1, -1)[:, :n].to(vals.dtype)
        return out.reshape(batch + (n,) + feat)

    def _reduce_by_first(self, vals, seg_ids, num_segments):
        """``min_by_first``: stable sort of the ids, then the sorted
        segmented scan of ``core.segmented`` over (key rank, row)."""
        if vals.dim() != seg_ids.dim() + 1:
            raise ValueError(
                "min_by_first reduces (*B, E, D) rows by (*B, E) ids; got "
                f"values {tuple(vals.shape)} and ids {tuple(seg_ids.shape)}")
        seg, order = torch.sort(seg_ids.long(), dim=-1, stable=True)
        rows = vals.gather(-2, order[..., None].expand_as(vals))
        starts = torch.ones_like(seg, dtype=torch.bool)
        starts[..., 1:] = seg[..., 1:] != seg[..., :-1]
        rank = _first_key_rank(rows[..., 0], starts)
        big = torch.iinfo(torch.int64).max

        def combine(later, earlier):
            take = later[0] <= earlier[0]
            return [torch.where(take, later[0], earlier[0]),
                    torch.where(take[..., None], later[1], earlier[1])]

        _, out = segmented.segmented_reduce_sorted(
            [rank, rows], seg, num_segments, combine,
            [lambda r: torch.full_like(r, big), self.identity_like])
        return out

    def reduce_workers(self, x: torch.Tensor) -> torch.Tensor:
        """Cross-worker reduction over dim 0 of all W workers' rows,
        broadcast back to every worker — ``LocalWorkers.reduce``
        (``repro_torch.distributed.workers``, which holds the fold order
        both backends share)."""
        return workers.LocalWorkers(x.shape[0]).reduce(x, self)


SUM = Combiner("sum", 0.0)
MIN = Combiner("min", math.inf)
MAX = Combiner("max", -math.inf)
OR = Combiner("or", False)
PROD = Combiner("prod", 1.0)
MIN_BY_FIRST = Combiner("min_by_first", math.inf)

BY_NAME = {c.name: c for c in (SUM, MIN, MAX, OR, PROD, MIN_BY_FIRST)}


def get(name_or_combiner) -> Combiner:
    if isinstance(name_or_combiner, Combiner):
        return name_or_combiner
    return BY_NAME[name_or_combiner]
