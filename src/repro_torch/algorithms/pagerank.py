"""PageRank (paper Fig. 1 / Table V top).

The port of ``repro.algorithms.pagerank``, variant ``"scatter"``: the
ScatterCombine channel (static plan, no ids on the wire) carries the
rank contributions — both of its combines run the ``segment_combine``
kernel on the card — and an Aggregator sums the sink mass. ``"basic"``
and ``"personal"`` are not ported yet (ROADMAP).

``use_kernel=None`` (the default) means the kernel on the card and the
plain version on the CPU; ``use_kernel=False`` with a graph on the card
raises (``repro_torch.kernels.ops``). The JAX program defaults to
``use_kernel=False``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import aggregator as agg
from repro_torch.core import scatter_combine as sc
from repro_torch.pregel.program import VertexProgram

VARIANTS = ("scatter",)


def program(variant: str = "scatter", *, iters: int = 30,
            damping: float = 0.85,
            use_kernel: Optional[bool] = None) -> VertexProgram:
    """PageRank as a VertexProgram. Output: (n,) ranks in old-id space."""
    if variant in ("basic", "personal"):
        raise NotImplementedError(
            f"pagerank:{variant} is not ported yet (see ROADMAP)")
    if variant not in VARIANTS:
        raise ValueError(variant)

    def init(pg):
        n = torch.tensor(float(pg.n), dtype=torch.float32)
        return {"pr": torch.where(pg.v_mask, 1.0 / n.to(pg.device), 0.0)}

    def step(ctx, gs, state, step_idx):
        n = torch.tensor(float(gs.n), dtype=torch.float32, device=gs.device)
        pr = state["pr"]
        deg = torch.clamp(gs.deg_out, min=1).to(torch.float32)
        contrib = torch.where(gs.deg_out > 0, pr / deg, 0.0)
        incoming = sc.broadcast_combine(
            ctx, gs.scatter_out, contrib, "sum", use_kernel=use_kernel)
        sink = agg.aggregate(
            ctx, torch.where((gs.deg_out == 0) & gs.v_mask, pr, 0.0), "sum")
        new_pr = torch.where(
            gs.v_mask,
            (1 - damping) / n + damping * (incoming + sink[:, None] / n),
            0.0)
        return {"pr": new_pr}, step_idx >= iters - 1

    def extract(pg, state):
        return pg.to_global(state["pr"])

    return VertexProgram(
        name=f"pagerank:{variant}", init=init, step=step, extract=extract,
        max_steps=iters,
        meta={"algorithm": "pagerank", "variant": variant, "iters": iters,
              "damping": damping},
    )
