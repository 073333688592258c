"""Pointer jumping (paper Table V middle): every vertex of a rooted
forest finds its root by repeated D[u] <- D[D[u]].

The port of ``repro.algorithms.pointer_jumping``. Variants:

  - ``"basic"``: two DirectMessage rounds per superstep (ids both ways,
    no dedup) — Pregel's way;
  - ``"reqresp"``: the RequestRespond channel (dedup + positional
    replies).

The forest (an old-id parent array) is the problem input, closed over
by ``init``. ``"reqresp"`` also carries a query axis (``query_init``, as
in the JAX package): one query is one forest over the same vertex set,
so ``Engine.run_batch`` and ``Engine.serve`` jump Q forests at once, the
lanes' requests deduped and routed once over their union
(``request_respond._request_union``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.algorithms import common
from repro_torch.core import request_respond as rr
from repro_torch.graph.pgraph import PartitionedGraph
from repro_torch.pregel.program import VertexProgram, lane_view

VARIANTS = ("basic", "reqresp")


def parents_to_local(pg: PartitionedGraph,
                     parents_old: np.ndarray) -> torch.Tensor:
    """(n,) old-id parent array -> (W, n_loc) int32 in new-id space (the
    rows ``pg`` holds); pad slots point to themselves."""
    new = pg.new_of_old
    flat = np.arange(pg.n_pad, dtype=np.int64)
    flat[new] = new[parents_old]
    return torch.as_tensor(
        pg.mine(flat.reshape(pg.num_workers, pg.n_loc).astype(np.int32)),
        device=pg.device)


def program(variant: str = "reqresp", *, parents: np.ndarray,
            max_steps: int = 64) -> VertexProgram:
    """Pointer jumping as a VertexProgram. Output: (n,) root ids in the
    *new*-id space."""
    if variant not in VARIANTS:
        raise ValueError(variant)

    def init(pg):
        return {"P": parents_to_local(pg, parents)}

    def query_init(pg, parents_q):
        # one query = one forest over the same vertex set (e.g. the
        # per-label pointer structures of a multi-label contraction)
        return {"P": parents_to_local(pg, parents_q)}

    def step(ctx, gs, state, step_idx):
        p = state["P"]
        if variant == "reqresp":
            grand, overflow = rr.request(ctx, p, gs.v_mask, p,
                                         capacity=ctx.n_loc)
        else:
            grand, overflow = common.direct_request_respond(
                ctx, p, gs.v_mask, p)
        newp = torch.where(lane_view(gs.v_mask, p), grand, p)
        return {"P": newp}, (newp == p).all(dim=-1), overflow

    def extract(pg, state):
        return pg.to_global(state["P"])

    return VertexProgram(
        name=f"pj:{variant}", init=init, step=step, extract=extract,
        query_init=query_init if variant == "reqresp" else None,
        max_steps=max_steps, meta={"algorithm": "pj", "variant": variant},
    )
