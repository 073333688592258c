"""Weakly Connected Components — HCC min-label (paper Table V bottom).

The port of ``repro.algorithms.wcc``. Variants:

  - ``"basic"``: per superstep, changed vertices send their label to all
    neighbours over a CombinedMessage channel (Pregel/HCC style,
    O(diameter) supersteps); the routed exchange ranks its messages with
    the ``bucket_ranks`` kernel on the card.
  - ``"prop"``: the Propagation channel (``repro_torch.core.propagation``)
    in one superstep: a local fixpoint over partition-internal edges
    between exchanges over the cut edges; ``state["info"]`` holds each
    worker's (global rounds, local iterations).
  - ``"switch"``: the density-adaptive data plane
    (``repro_torch.core.compose.density_adaptive_combine``): each
    superstep the live frontier fraction picks the planned
    ScatterCombine broadcast (dense: no ids on the wire) at or above
    ``dense_threshold`` and the routed CombinedMessage push (sparse: only
    changed labels travel) below it. Labels, supersteps and halting are
    identical to ``"basic"``; only the traffic moves, attributed under
    ``wcc/dense/...`` and ``wcc/sparse/...``.

The graph must be symmetrized and needs the ``raw_out`` plan
(``"prop"`` ``prop_out``, ``"switch"`` also ``scatter_out``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import compose
from repro_torch.core import message as msg
from repro_torch.core import propagation as prop
from repro_torch.core.channel import on_device
from repro_torch.pregel.program import VertexProgram

INF32 = torch.iinfo(torch.int32).max

VARIANTS = ("basic", "prop", "switch")


def program(variant: str = "prop", *, max_steps: int = 10_000,
            dense_threshold: Optional[float] = None) -> VertexProgram:
    """Min-label WCC as a VertexProgram. Output: (n,) component labels in
    old-id space (min member id per component in the new id space)."""
    if variant not in VARIANTS:
        raise ValueError(variant)

    def extract(pg, state):
        return pg.to_global(state["lab"])

    if variant == "prop":

        def init(pg):
            return {
                "lab": torch.where(pg.v_mask, pg.global_ids(), INF32),
                "info": torch.zeros((pg.rows, 2), dtype=torch.int32,
                                    device=pg.device),
            }

        def step(ctx, gs, state, step_idx):
            lab, rounds, iters = prop.propagate(ctx, gs.prop_out,
                                                state["lab"], "min")
            lab = torch.where(gs.v_mask, lab, INF32)
            info = torch.stack([on_device(rounds, iters.device,
                                          iters.dtype).expand_as(iters),
                                iters], dim=1)
            return {"lab": lab, "info": info}, True

        return VertexProgram(
            name="wcc:prop", init=init, step=step, extract=extract,
            max_steps=1, meta={"algorithm": "wcc", "variant": variant},
        )

    # "basic" and "switch" share the min-label step; they differ only in
    # the exchange that delivers the neighbours' labels
    def exchange(ctx, gs, lab, active):
        raw = gs.raw_out
        src = raw.src_local.long()
        valid = raw.mask & active.gather(1, src)
        if variant == "basic":
            inc, _, ovf = msg.combined_send(
                ctx, raw.dst_global, valid, lab.gather(1, src), "min",
                capacity=ctx.edge_capacity(ctx.n_loc))
            return inc, ovf
        frac = compose.global_fraction(
            ctx, (active & gs.v_mask).sum(dim=1), gs.v_mask.sum(dim=1))
        inc, ovf, _ = compose.density_adaptive_combine(
            ctx, "wcc", frac, dense_threshold,
            plan=gs.scatter_out,
            dense_vals=torch.where(gs.v_mask, lab, INF32),
            dst=raw.dst_global, valid=valid,
            sparse_vals=lab.gather(1, src),
            combiner="min", capacity=ctx.edge_capacity(ctx.n_loc))
        return inc, ovf

    def init(pg):
        return {
            "lab": torch.where(pg.v_mask, pg.global_ids(), INF32),
            "active": pg.v_mask.clone(),
        }

    def step(ctx, gs, state, step_idx):
        lab, active = state["lab"], state["active"]
        inc, overflow = exchange(ctx, gs, lab, active)
        new = torch.where(gs.v_mask, torch.minimum(lab, inc), lab)
        new_active = new != lab
        halt = ~new_active.any(dim=1)
        return {"lab": new, "active": new_active}, halt, overflow

    return VertexProgram(
        name=f"wcc:{variant}", init=init, step=step, extract=extract,
        max_steps=max_steps,
        meta={"algorithm": "wcc", "variant": variant,
              "dense_threshold": dense_threshold},
    )
