"""Aggregator channel (paper Table I): a global reduction available to
every vertex next superstep; traffic is accounted like the paper does
(one value per worker toward the master, broadcast back).

The port of ``repro.core.aggregator``: the local reduce runs over each
worker's vertex axis (dim 1) and the cross-worker collective is a
reduction over dim 0, broadcast back to every worker.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import combiners as cb
from repro_torch.core.channel import ChannelContext, on_device


def aggregate(
    ctx: ChannelContext,
    values: torch.Tensor,
    combiner,
    valid: Optional[torch.Tensor] = None,
    *,
    name: str = "aggregator",
) -> torch.Tensor:
    """Combine ``values`` over all vertices of all workers.

    Args:
      values: (W, n_loc, ...) per-vertex contributions.
      valid: (W, n_loc) mask of contributing vertices (default: all).
    Returns:
      (W, ...) the global combined value, replicated on every worker.
    """
    if ctx.batched:
        raise NotImplementedError(
            "aggregate under the batched query plane is not ported yet "
            "(see ROADMAP)")
    combiner = cb.get(combiner)
    if valid is not None:
        mask = valid.reshape(valid.shape + (1,) * (values.dim() - valid.dim()))
        values = torch.where(mask, values, combiner.ident_for(values.dtype))
    if combiner.name == "sum":
        local = values.sum(dim=1)
    elif combiner.name == "min":
        local = values.amin(dim=1)
    elif combiner.name == "max":
        local = values.amax(dim=1)
    elif combiner.name == "or":
        local = values.any(dim=1)
    else:
        raise ValueError(f"combiner {combiner.name!r} is not ported yet")
    out = combiner.reduce_workers(local)
    per = values.element_size()
    for dim in values.shape[2:]:
        per *= int(dim)
    # 2(W-1) values on the wire: gather + broadcast
    w = ctx.num_workers
    ctx.add_traffic(name, 2 * (w - 1) * per, 2 * (w - 1))
    return out


def all_halted(ctx: ChannelContext, local_halt) -> torch.Tensor:
    """Voting-to-halt: a 0-d bool, true iff every worker votes halt
    (``local_halt`` is a (W,) vote or one scalar vote for all). Under the
    batched query plane the votes are (W, Q) and the result is (Q,), one
    verdict per query lane."""
    votes = on_device(local_halt, ctx.device, torch.bool)
    return votes.expand(ctx.stat_shape).all(dim=0)
