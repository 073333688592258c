"""Generic sorted segmented reduction for combiners that are not a
PyTorch scatter reduction — the port of ``repro.core.segmented``.

``Combiner.segment_reduce("min_by_first")`` (Boruvka's min-by-weight
candidate with its payload, paper Table IV) reduces through it on the
CPU, after a stable sort of the ids, as the JAX package does; it is the
plain version the ``segment_combine`` kernel's ``min_by_first`` is held
to on the card. The scan is the JAX package's segmented Hillis-Steele
ladder, over the last axis of the ids with any batch dims in front.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch


def segmented_reduce_sorted(leaves: Sequence[torch.Tensor],
                            seg: torch.Tensor, num_segments: int,
                            combine_fn: Callable,
                            idents: Sequence[Callable]):
    """Reduce each leaf within runs of equal (sorted) ``seg``.

    Args:
      leaves: tensors of shape ``(*B, E, ...)`` reduced together.
      seg: ``(*B, E)`` integer segment ids, sorted along the last axis;
        ids outside ``[0, num_segments)`` are dropped.
      num_segments: N, output rows per batch row.
      combine_fn: ``combine_fn(later, earlier) -> combined``, each a list
        of leaves shaped like ``leaves``; associative.
      idents: per leaf, ``leaf -> identity`` of the same shape and dtype.
    Returns:
      list of ``(*B, N, ...)`` tensors; empty segments hold the identity.
    """
    batch, e = tuple(seg.shape[:-1]), seg.shape[-1]
    r, n = math.prod(batch), num_segments
    s = seg.reshape(r, e).long()
    vs = [x.reshape((r, e) + tuple(x.shape[seg.dim():])) for x in leaves]

    def bcast(mask, x):
        return mask.reshape(mask.shape + (1,) * (x.dim() - 2))

    shift = 1
    while shift < e:
        prev_s = torch.cat([s.new_full((r, shift), -1), s[:, :-shift]], 1)
        same = prev_s == s
        shifted = [torch.cat([ident(v)[:, :shift], v[:, :-shift]], 1)
                   for v, ident in zip(vs, idents)]
        combined = combine_fn(vs, shifted)
        vs = [torch.where(bcast(same, v), c, v) for v, c in zip(vs, combined)]
        shift *= 2

    # the last position of each segment holds its reduction
    ids = torch.arange(n, device=s.device).expand(r, n).contiguous()
    last = torch.searchsorted(s, ids, right=True) - 1
    first = torch.searchsorted(s, ids, right=False)
    nonempty = last >= first
    at = last.clamp(0, max(e - 1, 0))
    out = []
    for v, ident in zip(vs, idents):
        if e == 0:
            got = ident(v.new_empty((r, n) + tuple(v.shape[2:])))
        else:
            idx = bcast(at, v).expand((r, n) + tuple(v.shape[2:]))
            got = v.gather(1, idx)
        got = torch.where(bcast(nonempty, got), got, ident(got))
        out.append(got.reshape(batch + (n,) + tuple(v.shape[2:])))
    return out
