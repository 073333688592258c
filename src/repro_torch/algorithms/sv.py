"""Shiloach-Vishkin connected components (paper §III-C, §V, Table VI).

The port of ``repro.algorithms.sv``, all six variants. Three
communication patterns, each with a baseline and an optimized channel:

  1. root test + pointer jumping (D[D[u]]): DirectMessage two-phase vs
     the RequestRespond channel [load balance];
  2. neighbour minimum (min D[e] over Nbr[u]): CombinedMessage per edge
     vs the ScatterCombine channel [neighbourhood traffic];
  3. remote min-update (D[D[u]] <?= t): CombinedMessage (min) in all
     variants [congestion].

``"basic"``, ``"reqresp"``, ``"scatter"`` and ``"both"`` are the paper's
programs 2-5 in Table VI; ``"monolithic"`` is the Pregel baseline with
one message type, combined only at the receiver.

``"composed"`` is the §V case study on the composition layer
(``repro_torch.core.compose``): one ``Stacked`` channel bundles the
request-respond pointer lookups, the min scatter-combine neighbour
minimum, the min-combined tree-merge message and a full pointer jumping
that makes every tree a star inside the superstep — fewer supersteps
AND fewer bytes than any single-channel variant. Traffic is attributed
under ``sv/pointer/request``, ``sv/pointer/respond``,
``sv/neighbor_min``, ``sv/merge`` and ``sv/jump``, and the program
declares that key set (``channels=<stack>``).

All variants converge to D[u] = min vertex id (new-id space) of u's
component, so their final states are identical. The graph must be
symmetrized and needs the ``scatter_out`` and ``raw_out`` plans.
"""
from __future__ import annotations

import torch

from repro_torch.algorithms import common
from repro_torch.core import combiners as cb
from repro_torch.core import compose
from repro_torch.core import message as msg
from repro_torch.core import request_respond as rr
from repro_torch.core import scatter_combine as sc
from repro_torch.pregel.program import VertexProgram

INF32 = torch.iinfo(torch.int32).max

VARIANTS = ("basic", "reqresp", "scatter", "both", "monolithic", "composed")


def composed_channels() -> compose.Stacked:
    """The §V composition: the three optimized channels plus full
    jumping, stacked under the ``sv/`` namespace."""

    def neighbor_min(ctx, name, plan, vals):
        return sc.broadcast_combine(ctx, plan, vals, "min", name=name)

    return compose.stacked(
        "sv",
        pointer=compose.request_component(),
        neighbor_min=compose.Component(neighbor_min),
        merge=compose.combined_component("min"),
        jump=common.jump_component(),
    )


def _composed_step(chan: compose.Stacked):
    """One composed superstep: hook by neighbour minimum, then shortcut
    every tree to a star (full jumping) before the next global round."""

    def step(ctx, gs, state, step_idx):
        d = state["D"]

        # 1. is my parent a root? (grand == D[u]) — request-respond. After
        # step 4's full jumping every tree is a star, so this always
        # holds; the lookup stays because the paper's composed program
        # pays for it
        grand, ovf1 = chan.call(ctx, "pointer", d, gs.v_mask, d,
                                capacity=ctx.n_loc)
        parent_is_root = grand == d

        # 2. minimum neighbour pointer t — min scatter-combine
        t = chan.call(ctx, "neighbor_min", gs.scatter_out, d)

        # 3. tree merging: send t to the root D[u] with a min-combiner
        cond = gs.v_mask & parent_is_root & (t < d)
        minval, got, ovf3 = chan.call(ctx, "merge", d, cond, t,
                                      capacity=ctx.n_loc)
        d1 = torch.where(got & gs.v_mask, torch.minimum(d, minval), d)

        # 4. full pointer jumping: D[u] <- root(u), trees become stars
        # within the superstep
        d2, _ = chan.call(ctx, "jump", d1, gs.v_mask)
        d2 = torch.where(gs.v_mask, d2, d1)

        halt = (d2 == d).all(dim=1)
        return {"D": d2}, halt, ovf1 | ovf3

    return step


def _init(pg):
    return {"D": pg.global_ids()}  # D[u] = u (pads too)


def _extract(pg, state):
    return pg.to_global(state["D"])


def program(variant: str = "both", *,
            max_steps: int = 200) -> VertexProgram:
    """S-V as a VertexProgram. Output: (n,) component labels (min member
    id in the new-id space) in old-id order. On the card the
    ScatterCombine runs the ``segment_combine`` kernel."""
    if variant not in VARIANTS:
        raise ValueError(variant)
    meta = {"algorithm": "sv", "variant": variant}

    if variant == "composed":
        chan = composed_channels()
        return VertexProgram(
            name="sv:composed", init=_init, step=_composed_step(chan),
            extract=_extract, channels=chan, max_steps=max_steps, meta=meta)

    use_rr = variant in ("reqresp", "both")
    use_sc = variant in ("scatter", "both")
    monolithic = variant == "monolithic"

    def ask(ctx, gs, dst_per_vertex, vals):
        """D[dst] for every local vertex, via the selected channel."""
        if use_rr:
            return rr.request(ctx, dst_per_vertex, gs.v_mask, vals,
                              capacity=ctx.n_loc)
        return common.direct_request_respond(ctx, dst_per_vertex, gs.v_mask,
                                             vals)

    def mono_min(ctx, deliv, key):
        # receiver-side combine over unsorted delivery order: the plain
        # segment reduction (the kernel needs sorted segment ids)
        vals = torch.where(deliv.mask, deliv.payload[key], INF32)
        return cb.MIN.segment_reduce(vals, deliv.dst_local, ctx.n_loc)

    def neighbor_min(ctx, gs, vals):
        """min over the neighbours' vals, via the selected channel."""
        if use_sc:
            t = sc.broadcast_combine(ctx, gs.scatter_out, vals, "min")
            return t, torch.zeros(ctx.rows, dtype=torch.bool,
                                  device=ctx.device)
        raw = gs.raw_out
        per_edge = vals.gather(1, raw.src_local.long())
        if monolithic:
            # Pregel with an inapplicable global combiner: one message per
            # edge, combined only at the receiver (paper §V-A)
            deliv = msg.direct_send(ctx, raw.dst_global, raw.mask,
                                    {"v": per_edge}, capacity=raw.e_cap,
                                    name="mono_message")
            return mono_min(ctx, deliv, "v"), deliv.overflow
        inc, got, ovf = msg.combined_send(ctx, raw.dst_global, raw.mask,
                                          per_edge, "min",
                                          capacity=ctx.n_loc)
        return torch.where(got, inc, INF32), ovf

    def step(ctx, gs, state, step_idx):
        d = state["D"]

        # 1. is my parent a root? (grand == D[u])
        grand, ovf1 = ask(ctx, gs, d, d)
        parent_is_root = grand == d

        # 2. minimum neighbour pointer t
        t, ovf2 = neighbor_min(ctx, gs, d)

        # 3. tree merging: send t to the root D[u] with a min-combiner
        cond = gs.v_mask & parent_is_root & (t < d)
        if monolithic:
            deliv = msg.direct_send(ctx, d, cond, {"t": t},
                                    capacity=ctx.n_loc, name="mono_message")
            minval = mono_min(ctx, deliv, "t")
            got = minval != INF32
            ovf3 = deliv.overflow
        else:
            minval, got, ovf3 = msg.combined_send(
                ctx, d, cond, t, "min", capacity=ctx.n_loc,
                name="merge_message")
        d1 = torch.where(got & gs.v_mask, torch.minimum(d, minval), d)

        # 4. pointer jumping: D[u] <- D[D[u]] (one hop, reads merged values)
        grand2, ovf4 = ask(ctx, gs, d1, d1)
        d2 = torch.where(gs.v_mask, grand2, d1)

        halt = (d2 == d).all(dim=1)
        return {"D": d2}, halt, ovf1 | ovf2 | ovf3 | ovf4

    return VertexProgram(
        name=f"sv:{variant}", init=_init, step=step, extract=_extract,
        max_steps=max_steps, meta=meta)
