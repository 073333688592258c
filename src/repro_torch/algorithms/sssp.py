"""Single-source shortest paths (weighted Bellman-Ford flavor).

The port of ``repro.algorithms.sssp``. Variants:

  - ``"basic"``: per superstep, vertices whose distance improved send
    ``dist + w`` to their out-neighbors over a CombinedMessage channel
    and receivers keep the min;
  - ``"prop"``: the Propagation channel with ``edge_transform = dist +
    w`` in one superstep — the channel generalizes beyond min-label
    propagation; ``state["info"]`` holds each worker's (global rounds,
    local iterations); batched, ``(W, Q, 2)``, each lane's own.

The source is the program's query axis (``query_init``):
``Engine.run_batch(prog, pg, sources)`` computes landmark distances —
one distance array per source — in one loop. Each step serves both
``(W, n_loc)`` solo and ``(W, Q, n_loc)`` batched state (see
``repro_torch.algorithms.reachability``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import message as msg
from repro_torch.core import propagation as prop
from repro_torch.core.channel import on_device
from repro_torch.pregel.program import VertexProgram, gather_local, lane_view

VARIANTS = ("basic", "prop")


def _check_nonnegative_weights(pg) -> None:
    """Bellman-Ford with monotone-min halting is only correct on
    non-negative weights — a negative edge would need re-activation past
    the halt vote and silently yields wrong distances. Reject it at init
    (pad entries in the plans are zeros, so any negative entry is a real
    edge weight)."""
    ws = []
    if pg.raw_out is not None and pg.raw_out.w is not None:
        ws.append(pg.raw_out.w)
    if pg.prop_out is not None:
        ws += [x for x in (pg.prop_out.int_w, pg.prop_out.cut.edge_w)
               if x is not None]
    for w in ws:
        if bool((w < 0).any()):
            raise ValueError(
                f"sssp requires non-negative edge weights; graph "
                f"{pg.name!r} has min weight {float(w.min())}")


def program(variant: str = "basic", *, source: int = 0,
            max_steps: int = 10_000) -> VertexProgram:
    """SSSP as a VertexProgram. Output: (n,) float32 distances in old-id
    space (inf = unreachable)."""
    if variant not in VARIANTS:
        raise ValueError(variant)

    def dist0_of(pg, src_old):
        at_src = pg.global_ids() == int(pg.new_of_old[src_old])
        return torch.where(at_src, 0.0, math.inf).to(torch.float32), at_src

    def extract(pg, state):
        return pg.to_global(state["dist"])

    if variant == "prop":

        def query_init(pg, src_old):
            _check_nonnegative_weights(pg)
            return {"dist": dist0_of(pg, src_old)[0],
                    "info": torch.zeros((pg.rows, 2),
                                        dtype=torch.int32, device=pg.device)}

        def init(pg):
            return query_init(pg, source)

        def step(ctx, gs, state, step_idx):
            dist, rounds, iters = prop.propagate(
                ctx, gs.prop_out, state["dist"], "min",
                edge_transform=lambda v, w: v + w[..., None])
            info = torch.stack([on_device(rounds, iters.device,
                                          iters.dtype).expand_as(iters),
                                iters], dim=-1)
            return {"dist": dist, "info": info}, True

        return VertexProgram(
            name="sssp:prop", init=init, step=step, extract=extract,
            query_init=query_init, max_steps=1,
            meta={"algorithm": "sssp", "variant": variant, "source": source},
        )

    def query_init(pg, src_old):
        _check_nonnegative_weights(pg)
        dist0, at_src = dist0_of(pg, src_old)
        return {"dist": dist0, "active": at_src}

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

    return VertexProgram(
        name="sssp:basic", init=init, step=step, extract=extract,
        query_init=query_init, max_steps=max_steps,
        meta={"algorithm": "sssp", "variant": variant, "source": source},
    )
