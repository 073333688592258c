"""Weakly Connected Components — HCC min-label (paper Table V bottom).

The port of ``repro.algorithms.wcc``, variant ``"basic"``: per
superstep, changed vertices send their label to all neighbors over a
CombinedMessage channel (Pregel/HCC style, O(diameter) supersteps); the
routed exchange ranks its messages with the ``bucket_ranks`` kernel on
the card. ``"prop"`` and ``"switch"`` need the propagation plans and the
density switch, which are not ported yet (ROADMAP).

The graph must be symmetrized (undirected view) and needs the
``raw_out`` plan.
"""
from __future__ import annotations

import torch

from repro_torch.core import message as msg
from repro_torch.pregel.program import VertexProgram

INF32 = torch.iinfo(torch.int32).max

VARIANTS = ("basic",)


def program(variant: str = "basic", *,
            max_steps: int = 10_000) -> VertexProgram:
    """Min-label WCC as a VertexProgram. Output: (n,) component labels in
    old-id space (min member id per component in the new id space)."""
    if variant in ("prop", "switch"):
        raise NotImplementedError(
            f"wcc:{variant} is not ported yet (see ROADMAP)")
    if variant not in VARIANTS:
        raise ValueError(variant)

    def init(pg):
        return {
            "lab": torch.where(pg.v_mask, pg.global_ids(), INF32),
            "active": pg.v_mask.clone(),
        }

    def step(ctx, gs, state, step_idx):
        lab, active = state["lab"], state["active"]
        raw = gs.raw_out
        src = raw.src_local.long()
        valid = raw.mask & active.gather(1, src)
        inc, _, overflow = msg.combined_send(
            ctx, raw.dst_global, valid, lab.gather(1, src), "min",
            capacity=ctx.edge_capacity(ctx.n_loc),
        )
        new = torch.where(gs.v_mask, torch.minimum(lab, inc), lab)
        new_active = new != lab
        halt = ~new_active.any(dim=1)
        return {"lab": new, "active": new_active}, halt, overflow

    def extract(pg, state):
        return pg.to_global(state["lab"])

    return VertexProgram(
        name=f"wcc:{variant}", init=init, step=step, extract=extract,
        max_steps=max_steps, meta={"algorithm": "wcc", "variant": variant},
    )
