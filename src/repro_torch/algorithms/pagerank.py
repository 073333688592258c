"""PageRank (paper Fig. 1 / Table V top).

The port of ``repro.algorithms.pagerank``. Variants:

  - ``"basic"``: the CombinedMessage channel (per-superstep routing, ids
    on the wire) — the standard-channel Fig. 1 program. Its float32
    ``sum`` combines are order-sensitive, so on the card both sides
    stable-sort their ids and run the ``segment_combine`` kernel
    (``kernels.ops.segment_reduce``): no float atomics, two runs
    bit-identical;
  - ``"scatter"``: the ScatterCombine channel (static plan, no ids on
    the wire) — both of its combines run the ``segment_combine`` kernel
    on the card.

An Aggregator sums the sink mass in all three. ``"personal"``:
personalized PageRank over the ScatterCombine channel, teleport and sink
mass concentrated on one source vertex. The source rides the *state* as
a per-worker scalar (``(W,)`` solo, ``(W, Q)`` batched), so the program
has a query axis (``query_init``): ``Engine.run_batch`` answers Q
sources in one loop, the lanes as the columns of each
``segment_combine`` launch, and ``Engine.serve`` serves them, each lane
halting after its own ``iters`` supersteps (the step index is then the
lanes' ages).

``use_kernel=None`` (the default) means the kernel on the card and the
plain version on the CPU; ``use_kernel=False`` with a graph on the card
raises (``repro_torch.kernels.ops``). The JAX program defaults to
``use_kernel=False``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import aggregator as agg
from repro_torch.core import message as msg
from repro_torch.core import scatter_combine as sc
from repro_torch.pregel.program import VertexProgram, lane_view

VARIANTS = ("basic", "scatter", "personal")


def program(variant: str = "scatter", *, iters: int = 30,
            damping: float = 0.85, source: int = 0,
            use_kernel: Optional[bool] = None) -> VertexProgram:
    """PageRank as a VertexProgram. Output: (n,) ranks in old-id space.
    ``source`` (an old id) is the personalization vertex of
    ``"personal"``."""
    if variant not in VARIANTS:
        raise ValueError(variant)
    if variant == "personal":
        return _personal(iters=iters, damping=damping, source=source,
                         use_kernel=use_kernel)

    def init(pg):
        n = torch.tensor(float(pg.n), dtype=torch.float32)
        return {"pr": torch.where(pg.v_mask, 1.0 / n.to(pg.device), 0.0)}

    def step(ctx, gs, state, step_idx):
        n = torch.full((), float(gs.n), dtype=torch.float32,
                       device=gs.device)
        pr = state["pr"]
        deg = torch.clamp(gs.deg_out, min=1).to(torch.float32)
        contrib = torch.where(gs.deg_out > 0, pr / deg, 0.0)
        overflow = torch.zeros(ctx.rows, dtype=torch.bool,
                               device=gs.device)
        if variant == "scatter":
            incoming = sc.broadcast_combine(
                ctx, gs.scatter_out, contrib, "sum", use_kernel=use_kernel)
        else:
            raw = gs.raw_out
            incoming, _, overflow = msg.combined_send(
                ctx, raw.dst_global, raw.mask,
                contrib.gather(1, raw.src_local.long()), "sum",
                capacity=ctx.edge_capacity(ctx.n_loc), use_kernel=use_kernel)
        sink = agg.aggregate(
            ctx, torch.where((gs.deg_out == 0) & gs.v_mask, pr, 0.0), "sum")
        new_pr = torch.where(
            gs.v_mask,
            (1 - damping) / n + damping * (incoming + sink[:, None] / n),
            0.0)
        return {"pr": new_pr}, step_idx >= iters - 1, overflow

    def extract(pg, state):
        return pg.to_global(state["pr"])

    return VertexProgram(
        name=f"pagerank:{variant}", init=init, step=step, extract=extract,
        max_steps=iters,
        meta={"algorithm": "pagerank", "variant": variant, "iters": iters,
              "damping": damping},
    )


def _personal(*, iters: int, damping: float, source: int,
              use_kernel: Optional[bool]) -> VertexProgram:
    """Personalized PageRank: teleport and sink mass concentrate on one
    source vertex, which rides the state as a per-worker scalar (not a
    closure constant), so one step serves any source and any number of
    lanes."""

    def query_init(pg, src_old):
        src_new = int(pg.new_of_old[src_old])
        e = (pg.global_ids() == src_new) & pg.v_mask
        return {"pr": e.to(torch.float32),
                "src": torch.full((pg.rows,), src_new,
                                  dtype=torch.int32, device=pg.device)}

    def init(pg):
        return query_init(pg, source)

    def step(ctx, gs, state, step_idx):
        pr, src = state["pr"], state["src"]
        ids = gs.global_ids()
        e = ((lane_view(ids, pr) == src[..., None])
             & lane_view(gs.v_mask, pr)).to(torch.float32)
        deg = torch.clamp(gs.deg_out, min=1).to(torch.float32)
        contrib = torch.where(lane_view(gs.deg_out > 0, pr),
                              pr / lane_view(deg, pr), 0.0)
        incoming = sc.broadcast_combine(ctx, gs.scatter_out, contrib, "sum",
                                        use_kernel=use_kernel)
        sink = agg.aggregate(
            ctx, torch.where(lane_view((gs.deg_out == 0) & gs.v_mask, pr),
                             pr, 0.0), "sum")
        new_pr = torch.where(
            lane_view(gs.v_mask, pr),
            (1 - damping) * e + damping * (incoming + sink[..., None] * e),
            0.0)
        return {"pr": new_pr, "src": src}, step_idx >= iters - 1

    def extract(pg, state):
        return pg.to_global(state["pr"])

    return VertexProgram(
        name="pagerank:personal", init=init, step=step, extract=extract,
        query_init=query_init, max_steps=iters,
        meta={"algorithm": "pagerank", "variant": "personal", "iters": iters,
              "damping": damping, "source": source})
