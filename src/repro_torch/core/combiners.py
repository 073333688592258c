"""Combiners — associative/commutative reduction operators for channels
(paper Table I; the per-channel combiner parameter of every §IV-C channel).

The port of ``repro.core.combiners``. ``segment_reduce`` is the plain
PyTorch segment reduction every channel uses off the kernel path: ids
outside ``[0, num_segments)`` land in a dump row that is cut off (JAX
drops them silently; PyTorch would raise or fault on them). Empty ``or``
segments hold False, the identity — the JAX reference's ``segment_max``
cast gives True there (ROADMAP fault 3).

``sum``, ``min``, ``max`` and ``or`` are ported; ``prod`` and
``min_by_first`` come with the slices that need them (ROADMAP).
"""
from __future__ import annotations

import dataclasses
import math

import torch

_SCATTER_REDUCE = {"min": "amin", "max": "amax", "or": "amax"}


@dataclasses.dataclass(frozen=True)
class Combiner:
    """An associative, commutative binary reduction with identity.

    Attributes:
      name: short tag ("sum" | "min" | "max" | "or").
      identity: identity element (python scalar; cast to the value dtype).
    """

    name: str
    identity: float

    def ident_for(self, dtype: torch.dtype):
        integer = not dtype.is_floating_point and dtype != torch.bool
        if self.name == "min":
            return torch.iinfo(dtype).max if integer else math.inf
        if self.name == "max":
            return torch.iinfo(dtype).min if integer else -math.inf
        return self.identity

    def segment_reduce(self, vals: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
        """Segment reduction over the last axis of ``seg_ids``.

        Args:
          vals: ``(*B, E, *F)`` values.
          seg_ids: ``(*B, E)`` integer segment id per value, sorted or
            not; ids outside ``[0, num_segments)`` are dropped.
          num_segments: N, the number of output rows per batch row.
        Returns:
          ``(*B, N, *F)``; empty segments hold the identity.
        """
        if self.name not in ("sum", "min", "max", "or"):
            raise ValueError(
                f"combiner {self.name!r} is not ported yet (ROADMAP)")
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

    def reduce_workers(self, x: torch.Tensor) -> torch.Tensor:
        """Cross-worker reduction over dim 0 (the W axis), broadcast back
        to every worker — the port of ``psum``/``pmin``/``pmax``."""
        if self.name == "sum":
            red = x.sum(0, keepdim=True)
        elif self.name == "min":
            red = x.amin(0, keepdim=True)
        elif self.name == "max":
            red = x.amax(0, keepdim=True)
        elif self.name == "or":
            red = x.any(0, keepdim=True)
        else:
            raise ValueError(self.name)
        return red.expand_as(x)


SUM = Combiner("sum", 0.0)
MIN = Combiner("min", math.inf)
MAX = Combiner("max", -math.inf)
OR = Combiner("or", False)

BY_NAME = {c.name: c for c in (SUM, MIN, MAX, OR)}


def get(name_or_combiner) -> Combiner:
    if isinstance(name_or_combiner, Combiner):
        return name_or_combiner
    if name_or_combiner not in BY_NAME:
        raise ValueError(
            f"combiner {name_or_combiner!r} is not ported yet (ROADMAP)")
    return BY_NAME[name_or_combiner]
