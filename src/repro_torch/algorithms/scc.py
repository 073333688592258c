"""Min-Label SCC (Yan et al. [30]; paper Table VII).

The port of ``repro.algorithms.scc``. Iterative rounds of: trivial-SCC
removal, forward min-label propagation (along out-edges), backward
min-label propagation (along in-edges); the vertices with F == B form
the SCC of that label and freeze.

Variants:
  - ``"basic"``: forward/backward phases by one CombinedMessage
    superstep an iteration (``common.cm_propagate``).
  - ``"prop"``: forward/backward phases by the Propagation channel — the
    paper's 'quick fix not possible in any existing system'.

``state["iters"]`` counts each worker's propagation iterations over all
rounds (local fixpoint iterations for ``"prop"``, CombinedMessage
iterations for ``"basic"``).
"""
from __future__ import annotations

import torch

from repro_torch.algorithms import common
from repro_torch.core import compose
from repro_torch.core import propagation as prop
from repro_torch.core import scatter_combine as sc
from repro_torch.pregel.program import VertexProgram

INF32 = torch.iinfo(torch.int32).max

VARIANTS = ("basic", "prop")


def program(variant: str = "prop", *, max_steps: int = 500) -> VertexProgram:
    """Min-label SCC as a VertexProgram. Output: (n,) SCC labels (min
    member id) in old-id space. The graph must be built with
    scatter_out+scatter_in and (prop_out+prop_in for "prop") or
    (raw_out+raw_in for "basic") on the DIRECTED graph."""
    if variant not in VARIANTS:
        raise ValueError(variant)

    def min_label(ctx, gs, alive, direction):
        lab0 = torch.where(alive, gs.global_ids(), INF32)
        if variant == "prop":
            # propagate() works on (W, n_loc, D) labels: broadcast the mask
            amask = alive[..., None]
            plan = gs.prop_out if direction == "fwd" else gs.prop_in
            lab, _, iters = prop.propagate(
                ctx, plan, lab0, "min",
                update=lambda lab, inc: torch.where(
                    amask, torch.minimum(lab, inc), lab),
                src_values=lambda lab: torch.where(amask, lab, INF32),
                name=f"propagation/{direction}")
            return lab, iters
        raw = gs.raw_out if direction == "fwd" else gs.raw_in
        return common.cm_propagate(
            ctx, raw, lab0, "min", active0=alive,
            update=lambda lab, inc, got: torch.where(
                alive, torch.minimum(lab, inc), lab),
            name=f"basic_propagation/{direction}")

    def step(ctx, gs, state, step_idx):
        alive, scc_lab = state["alive"], state["scc"]
        gid = gs.global_ids()

        # trivial removal: alive in/out degree == 0 => own SCC. The two
        # scatter-combines are independent, so the composition layer
        # merges them into a single collective round (paper §V).
        alive_f = alive.to(torch.float32)
        in_alive, out_alive = compose.fused_exchange(ctx, [
            sc.plan_broadcast_combine(ctx, gs.scatter_out, alive_f, "sum",
                                      name="degree/out"),
            sc.plan_broadcast_combine(ctx, gs.scatter_in, alive_f, "sum",
                                      name="degree/in"),
        ])
        trivial = alive & ((in_alive == 0) | (out_alive == 0))
        scc_lab = torch.where(trivial, gid, scc_lab)
        alive = alive & ~trivial

        # forward/backward min-label among alive
        f_lab, it_f = min_label(ctx, gs, alive, "fwd")
        b_lab, it_b = min_label(ctx, gs, alive, "bwd")
        found = alive & (f_lab == b_lab) & (f_lab != INF32)
        scc_lab = torch.where(found, f_lab, scc_lab)
        alive = alive & ~found

        return {
            "alive": alive,
            "scc": scc_lab,
            "iters": state["iters"] + it_f + it_b,
        }, ~alive.any(dim=1)

    def init(pg):
        return {
            "alive": pg.v_mask.clone(),
            "scc": torch.full((pg.rows, pg.n_loc), -1,
                              dtype=torch.int32, device=pg.device),
            "iters": torch.zeros(pg.rows, dtype=torch.int32,
                                 device=pg.device),
        }

    def extract(pg, state):
        return pg.to_global(state["scc"])

    return VertexProgram(
        name=f"scc:{variant}", init=init, step=step, extract=extract,
        max_steps=max_steps, meta={"algorithm": "scc", "variant": variant},
    )
