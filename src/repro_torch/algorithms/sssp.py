"""Single-source shortest paths (weighted Bellman-Ford flavor) over the
CombinedMessage channel.

The port of ``repro.algorithms.sssp``, variant ``"basic"``: per
superstep, vertices whose distance improved send ``dist + w`` to their
out-neighbors and receivers keep the min. ``"prop"`` needs the
propagation plans, which are not ported yet (ROADMAP).

The source is the program's query axis (``query_init``):
``Engine.run_batch(prog, pg, sources)`` computes landmark distances —
one distance array per source — in one host loop. The step serves both
``(W, n_loc)`` solo and ``(W, Q, n_loc)`` batched state (see
``repro_torch.algorithms.reachability``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import message as msg
from repro_torch.pregel.program import VertexProgram, gather_local, lane_view

VARIANTS = ("basic",)


def _check_nonnegative_weights(pg) -> None:
    """Bellman-Ford with monotone-min halting is only correct on
    non-negative weights — a negative edge would need re-activation past
    the halt vote and silently yields wrong distances. Reject it at init
    (pad entries of ``raw_out.w`` are zeros, so any negative entry is a
    real edge weight; the prop plans that the JAX check also reads are
    not ported)."""
    w = pg.raw_out.w if pg.raw_out is not None else None
    if w is not None and bool((w < 0).any()):
        raise ValueError(
            f"sssp requires non-negative edge weights; graph {pg.name!r} "
            f"has min weight {float(w.min())}")


def program(variant: str = "basic", *, source: int = 0,
            max_steps: int = 10_000) -> VertexProgram:
    """SSSP as a VertexProgram. Output: (n,) float32 distances in old-id
    space (inf = unreachable)."""
    if variant == "prop":
        raise NotImplementedError(
            "sssp:prop is not ported yet (see ROADMAP)")
    if variant not in VARIANTS:
        raise ValueError(variant)

    def query_init(pg, src_old):
        _check_nonnegative_weights(pg)
        at_src = pg.global_ids() == int(pg.new_of_old[src_old])
        return {"dist": torch.where(at_src, 0.0, math.inf).to(torch.float32),
                "active": at_src}

    def init(pg):
        return query_init(pg, source)

    def step(ctx, gs, state, step_idx):
        dist, active = state["dist"], state["active"]
        raw = gs.raw_out
        send_val = gather_local(dist, raw.src_local) + lane_view(raw.w, dist)
        valid = lane_view(raw.mask, dist) & gather_local(active,
                                                         raw.src_local)
        inc, _, overflow = msg.combined_send(
            ctx, raw.dst_global, valid, send_val, "min",
            capacity=ctx.edge_capacity(ctx.n_loc),
        )
        new = torch.where(lane_view(gs.v_mask, dist),
                          torch.minimum(dist, inc), dist)
        new_active = new < dist
        return ({"dist": new, "active": new_active},
                ~new_active.any(dim=-1), overflow)

    def extract(pg, state):
        return pg.to_global(state["dist"])

    return VertexProgram(
        name="sssp:basic", init=init, step=step, extract=extract,
        query_init=query_init, max_steps=max_steps,
        meta={"algorithm": "sssp", "variant": variant, "source": source},
    )
