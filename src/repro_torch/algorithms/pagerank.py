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

An Aggregator sums the sink mass in both. ``"personal"`` is not ported
yet (ROADMAP).

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
from repro_torch.pregel.program import VertexProgram

VARIANTS = ("basic", "scatter")


def program(variant: str = "scatter", *, iters: int = 30,
            damping: float = 0.85,
            use_kernel: Optional[bool] = None) -> VertexProgram:
    """PageRank as a VertexProgram. Output: (n,) ranks in old-id space."""
    if variant == "personal":
        raise NotImplementedError(
            f"pagerank:{variant} is not ported yet (see ROADMAP)")
    if variant not in VARIANTS:
        raise ValueError(variant)

    def init(pg):
        n = torch.tensor(float(pg.n), dtype=torch.float32)
        return {"pr": torch.where(pg.v_mask, 1.0 / n.to(pg.device), 0.0)}

    def step(ctx, gs, state, step_idx):
        n = torch.full((), float(gs.n), dtype=torch.float32,
                       device=gs.device)
        pr = state["pr"]
        deg = torch.clamp(gs.deg_out, min=1).to(torch.float32)
        contrib = torch.where(gs.deg_out > 0, pr / deg, 0.0)
        overflow = torch.zeros(ctx.num_workers, dtype=torch.bool,
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
