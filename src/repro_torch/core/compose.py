"""Channel composition layer (paper §V) — the part this slice needs.

The port of ``PlannedExchange`` and ``fused_exchange`` from
``repro.core.compose``: several *independent* planned exchanges share one
collective round. ``Stacked``, ``switch_by_density`` and the other
combinators come with the ``sv:composed`` slice (ROADMAP).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Sequence

import torch

from repro_torch.core.channel import ChannelContext
from repro_torch.core.routing import exchange


@dataclasses.dataclass
class PlannedExchange:
    """A channel exchange split at the collective boundary.

    ``payload`` holds the ready-to-send buffers — a dict of
    ``(W_src, W_dst, C, ...)`` tensors where ``[q, p]`` is worker q's
    block for peer p. ``finish(recv)`` consumes the identically shaped
    received dict (``[p, q]`` = block from q) and produces the channel's
    result. ``nbytes``/``nmsgs`` is the (W,) remote traffic accounted
    under ``name``.
    """

    name: str
    payload: Dict[str, torch.Tensor]
    finish: Callable[[Dict[str, torch.Tensor]], Any]
    nbytes: Any
    nmsgs: Any


def fused_exchange(ctx: ChannelContext,
                   parts: Sequence[PlannedExchange]) -> List[Any]:
    """Execute several planned exchanges in one collective round: all
    send buffers of one dtype are flattened to ``(W, W, -1)``,
    concatenated and exchanged together; each part's ``finish`` runs on
    its own slice, in ``parts`` order, and each part's traffic is
    accounted under its own name. The parts must be data-independent."""
    groups: Dict[torch.dtype, list] = {}
    for pi, part in enumerate(parts):
        for key, leaf in part.payload.items():
            groups.setdefault(leaf.dtype, []).append((pi, key, leaf))

    recv: List[Dict[str, torch.Tensor]] = [{} for _ in parts]
    for items in groups.values():
        w = items[0][2].shape[0]
        cols = [leaf.reshape(w, w, -1) for _, _, leaf in items]
        back = exchange(torch.cat(cols, dim=2) if len(cols) > 1 else cols[0])
        off = 0
        for (pi, key, leaf), col in zip(items, cols):
            width = col.shape[2]
            recv[pi][key] = back[:, :, off:off + width].reshape(leaf.shape)
            off += width

    results = []
    for pi, part in enumerate(parts):
        ctx.add_traffic(part.name, part.nbytes, part.nmsgs)
        results.append(part.finish(recv[pi]))
    return results
