"""Aggregator channel (paper Table I): a global reduction available to
every vertex next superstep; traffic is accounted like the paper does
(one value per worker toward the master, broadcast back).

The port of ``repro.core.aggregator``: the local reduce runs over each
worker's vertex axis and the cross-worker collective is the workers
layer's reduction (``repro_torch.distributed.workers``), broadcast back
to every worker. Under the batched query plane the
values carry Q after W and each lane reduces alone.

Every batched lane must equal its solo run bit for bit, so a reduction
whose result depends on the order of its combines (a float ``sum`` or
``prod``, ``min_by_first``) follows one fixed order whatever Q is: the
local reduce is a pairwise tree over the vertex axis (elementwise ops
only, the same ones in a solo run, which is the Q=1 case of the same
code) and the workers fold in index order
(``ctx.workers.reduce``, on both backends). A library reduction would
pick its own strategy from the tensor's shape and could round a lane
differently than its solo run.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import combiners as cb
from repro_torch.core.channel import ChannelContext, on_device
from repro_torch.core.routing import lane_live


def _tree(values: torch.Tensor, dim: int, op, fill) -> torch.Tensor:
    """``op`` over ``dim`` as a pairwise tree: the axis padded with the
    identity ``fill`` to a power of two, then halved, ``op(low, high)``,
    until one entry is left. Every entry sees the same combines in the
    same order whatever the other dims hold."""
    n = values.shape[dim]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        pad = list(values.shape)
        pad[dim] = width - n
        values = torch.cat([values, values.new_full(pad, fill)], dim=dim)
    while width > 1:
        width //= 2
        values = op(values.narrow(dim, 0, width),
                    values.narrow(dim, width, width))
    return values.squeeze(dim)


def _first_min(values: torch.Tensor, dim: int, combiner) -> torch.Tensor:
    """The JAX package's ``min_by_first`` fold over ``dim`` from the
    identity, ``acc = fn(acc, x_i)`` (``acc`` kept where its key is
    ``<=``), without a loop: after the last NaN key the fold keeps the
    first entry with the least key; a NaN key in the last entry wins; a
    fold that never replaces its start (every key the identity's and no
    NaN) ends at the identity."""
    key = values.select(-1, 0)  # values (..., n, D): the key is column 0
    n = key.shape[dim]
    pos = torch.arange(n, device=values.device).reshape(
        (n,) + (1,) * (key.dim() - dim - 1))
    nan = key != key
    last_nan = torch.where(nan, pos, -1).amax(dim=dim, keepdim=True)
    after = pos > last_nan
    ident = combiner.ident_for(values.dtype)
    masked = torch.where(after, key, ident)
    least = masked.amin(dim=dim, keepdim=True)
    first = (after & (masked == least)).to(torch.int8).argmax(dim=dim,
                                                              keepdim=True)
    take = torch.where(last_nan == n - 1, n - 1, first)
    idx = take.unsqueeze(-1).expand(take.shape + values.shape[-1:])
    picked = values.gather(dim, idx).squeeze(dim)
    start = combiner.identity_like(picked)
    # no NaN and no key below the identity's: the fold kept its start
    kept_start = ((last_nan < 0) & (least == ident)).squeeze(dim)
    return torch.where(kept_start[..., None], start, picked)


def _local(values: torch.Tensor, dim: int, combiner) -> torch.Tensor:
    """The local reduce of ``values`` over ``dim`` (the vertex axis)."""
    name = combiner.name
    if name == "sum":
        return _tree(values, dim, torch.add, 0)
    if name == "prod":
        return _tree(values, dim, torch.mul, 1)
    if name == "min":
        return values.amin(dim=dim)
    if name == "max":
        return values.amax(dim=dim)
    if name == "or":
        return values.any(dim=dim)
    return _first_min(values, dim, combiner)


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
      values: (W, n_loc, ...) per-vertex contributions; (W, Q, n_loc,
        ...) under the batched query plane.
      valid: (W, n_loc) mask of contributing vertices (default: all);
        batched also (W, Q, n_loc).
      combiner: ``sum``, ``min``, ``max``, ``or``, ``prod`` or
        ``min_by_first`` (values (..., n_loc, D), the key in column 0).
    Returns:
      (W, ...) the global combined value, replicated on every worker;
      (W, Q, ...) batched. Each lane that is not live
      (``routing.lane_live``) is charged no traffic.
    """
    combiner = cb.get(combiner)
    dim = 2 if ctx.batched else 1
    if valid is not None:
        if ctx.batched and valid.dim() == 2:
            valid = valid[:, None]
        mask = valid.reshape(valid.shape + (1,) * (values.dim() - valid.dim()))
        values = torch.where(mask, values, combiner.ident_for(values.dtype))
    out = ctx.workers.reduce(_local(values, dim, combiner), combiner)
    per = values.element_size()
    for size in values.shape[dim + 1:]:
        per *= int(size)
    # 2(W-1) values on the wire: gather + broadcast
    w = ctx.num_workers
    nbytes, nmsgs = 2 * (w - 1) * per, 2 * (w - 1)
    if ctx.batched:
        live = lane_live(ctx)
        nbytes = torch.where(live, nbytes, 0).expand(ctx.stat_shape)
        nmsgs = torch.where(live, nmsgs, 0).expand(ctx.stat_shape)
    ctx.add_traffic(name, nbytes, nmsgs)
    return out


def all_halted(ctx: ChannelContext, local_halt) -> torch.Tensor:
    """Voting-to-halt: a 0-d bool, true iff every worker of this
    process votes halt (``local_halt`` is a (W,) vote or one scalar vote
    for all). Under the batched query plane the votes are (W, Q) and the
    result is (Q,), one verdict per query lane. On a rank of a group it
    is the rank's own vote; the host loop ANDs the ranks' votes in its
    one readback a superstep (``runtime._readback``)."""
    votes = on_device(local_halt, ctx.device, torch.bool)
    return votes.expand(ctx.stat_shape).all(dim=0)
