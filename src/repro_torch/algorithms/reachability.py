"""Multi-source reachability / BFS hop counts (directed frontier
expansion — unit-weight min-hop propagation over the CombinedMessage
channel, paper Table I).

The port of ``repro.algorithms.reachability``, variant ``"basic"``: per
superstep, frontier vertices send ``hop + 1`` to their out-neighbors and
receivers keep the min; O(eccentricity) supersteps from the source.

Output: (n,) int32 BFS levels in old-id space (``UNREACHED`` = int32 max
for vertices the source cannot reach).

The source vertex is the program's query axis (``query_init``):
``Engine.run_batch(prog, pg, sources)`` answers Q reachability queries in
one host loop, each halting the superstep its frontier dies. The step is
written once for both layouts — ``(W, n_loc)`` solo state and
``(W, Q, n_loc)`` batched state; batched, its CombinedMessage routes the
union frontier once through the ``bucket_ranks_lanes`` kernel on the
card, solo through ``bucket_ranks``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import message as msg
from repro_torch.pregel.program import VertexProgram, gather_local, lane_view

UNREACHED = torch.iinfo(torch.int32).max

VARIANTS = ("basic",)


def program(variant: str = "basic", *, source: int = 0,
            max_steps: int = 10_000) -> VertexProgram:
    """BFS reachability as a VertexProgram. Output: (n,) int32 hop counts
    in old-id space (UNREACHED where the source cannot reach)."""
    if variant not in VARIANTS:
        raise ValueError(variant)

    def query_init(pg, src_old):
        at_src = pg.global_ids() == int(pg.new_of_old[src_old])
        return {"hop": torch.where(at_src, 0, UNREACHED).to(torch.int32),
                "active": at_src}

    def init(pg):
        return query_init(pg, source)

    def step(ctx, gs, state, step_idx):
        hop, active = state["hop"], state["active"]
        raw = gs.raw_out
        valid = lane_view(raw.mask, hop) & gather_local(active, raw.src_local)
        # UNREACHED + 1 would wrap; invalid lanes are masked, so clip first
        send_val = torch.clamp(gather_local(hop, raw.src_local),
                               max=UNREACHED - 1) + 1
        inc, _, overflow = msg.combined_send(
            ctx, raw.dst_global, valid, send_val, "min",
            capacity=ctx.edge_capacity(ctx.n_loc),
        )
        new = torch.where(lane_view(gs.v_mask, hop), torch.minimum(hop, inc),
                          hop)
        new_active = new < hop
        return ({"hop": new, "active": new_active},
                ~new_active.any(dim=-1), overflow)

    def extract(pg, state):
        return pg.to_global(state["hop"])

    return VertexProgram(
        name=f"reach:{variant}", init=init, step=step, extract=extract,
        query_init=query_init, max_steps=max_steps,
        meta={"algorithm": "reach", "variant": variant, "source": source},
    )


def bfs_oracle(g, source: int) -> np.ndarray:
    """Host BFS levels (numpy frontier sweep) — the test oracle."""
    n = g.n
    hops = np.full(n, np.iinfo(np.int32).max, np.int32)
    hops[source] = 0
    src, dst = g.edges[:, 0], g.edges[:, 1]
    frontier = np.zeros(n, bool)
    frontier[source] = True
    level = 0
    while frontier.any():
        level += 1
        sel = frontier[src]
        nxt = np.zeros(n, bool)
        nxt[dst[sel]] = True
        nxt &= hops == np.iinfo(np.int32).max
        hops[nxt] = level
        frontier = nxt
    return hops
