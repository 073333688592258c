"""Minimum Spanning Forest — distributed Boruvka (Chung & Condon style,
the paper's MSF with heterogeneous message types; Table IV).

The port of ``repro.algorithms.msf``. Per round: every component finds
its minimum-weight outgoing edge (RequestRespond for the neighbour
components + a CombinedMessage whose ``min_by_first`` combiner carries a
4-tuple), hooks, breaks 2-cycles, pointer-jumps to the new roots, and
relabels.

Variants:
  - ``"channels"``: typed channels — requests are 4-byte ids, replies
    4-byte labels, only the candidates are 4-tuples. Built as a
    ``compose.Stacked`` under ``msf/`` with per-component traffic, and
    the program declares the stack's key set;
  - ``"monolithic"``: Pregel-style single message type — every message
    padded to the largest (the 16-byte 4-tuple), no request dedup.

The candidate combine is order-sensitive (an argmin carrying its
payload), so on the card both of its sides stable-sort their ids and run
the ``segment_combine`` kernel as ``min_by_first``.

Weights must be unique — the standard Boruvka assumption (R-MAT float32
weights collide at large scales; PERF.md bounds what that does to the
forest weight); ids must fit float32 exactly (n < 2**24).
"""
from __future__ import annotations

import torch

from repro_torch.algorithms import common
from repro_torch.core import compose
from repro_torch.core import message as msg
from repro_torch.pregel.program import VertexProgram

TUPLE_W = 16  # bytes of the largest message (w, comp, src, dst)

VARIANTS = ("channels", "monolithic")


def typed_channels() -> compose.Stacked:
    """The typed-channel Boruvka as one composed stack: three
    request-respond lookups, the min-by-weight candidate combiner, and
    the pointer-jumping fixpoint, namespaced under ``msf/``."""
    return compose.stacked(
        "msf",
        nbrcomp=compose.request_component(),
        candidate=compose.combined_component("min_by_first"),
        cycle=compose.request_component(),
        relabel=compose.request_component(),
        jump=common.jump_component(),
    )


def program(variant: str = "channels", *,
            max_steps: int = 64) -> VertexProgram:
    """Boruvka MSF as a VertexProgram. Output: dict with the total forest
    ``weight``, its ``edges`` count, and per-vertex component ``labels``
    (old-id order)."""
    if variant not in VARIANTS:
        raise ValueError(variant)
    typed = variant == "channels"
    pad = None if typed else TUPLE_W
    chan = typed_channels() if typed else None

    def ask(ctx, dst, valid, vals, name):
        if typed:
            return chan.call(ctx, name, dst, valid, vals, capacity=ctx.n_loc)
        return common.direct_request_respond(ctx, dst, valid, vals,
                                             name=name, wire_width=pad)

    def step(ctx, gs, state, step_idx):
        lab = state["L"]
        raw = gs.raw_out
        n_loc = ctx.n_loc
        base = ctx.me()[:, None] * n_loc
        gid = (base + torch.arange(n_loc, device=gs.device)).to(torch.int32)
        src = raw.src_local.long()

        # 1. neighbour component per edge. Typed: one RequestRespond over
        #    the edge destinations (deduped per worker). Monolithic: one
        #    DirectMessage request per edge, the edge slot riding along as
        #    the reply-matching tag
        if typed:
            nbr_comp, ovf1 = chan.call(ctx, "nbrcomp", raw.dst_global,
                                       raw.mask, lab, capacity=n_loc)
        else:
            nbr_comp, ovf1 = common.direct_request_respond(
                ctx, raw.dst_global, raw.mask, lab, name="nbrcomp",
                wire_width=pad,
                tags=torch.arange(raw.e_cap, dtype=torch.int32,
                                  device=gs.device))
        src_comp = lab.gather(1, src)
        cross = raw.mask & (src_comp != nbr_comp)

        # 2. min-weight outgoing edge per component (min-by-first 4-tuple)
        cand = torch.stack([raw.w, nbr_comp.to(torch.float32),
                            (base + src).to(torch.float32),
                            raw.dst_global.to(torch.float32)], dim=-1)
        if typed:
            minv, got, ovf2 = chan.call(ctx, "candidate", src_comp, cross,
                                        cand, capacity=n_loc)
        else:
            minv, got, ovf2 = msg.combined_send(
                ctx, src_comp, cross, cand, "min_by_first", capacity=n_loc,
                name="candidate", wire_width=pad)

        # 3. hook roots to the chosen neighbour component
        hook_to = minv[..., 1].to(torch.int32)
        d = torch.where(got, hook_to, gid)

        # 4. break 2-cycles (unique weights => both sides chose the same
        #    edge): the smaller id becomes the root and counts the edge
        grand, ovf3 = ask(ctx, d, gs.v_mask, d, "cycle")
        two_cycle = got & (grand == gid)
        d = torch.where(two_cycle & (gid < hook_to), gid, d)
        count_edge = got & (~two_cycle | (gid < hook_to))
        add_w = torch.where(count_edge, minv[..., 0], 0.0).sum(dim=1)
        add_c = count_edge.sum(dim=1, dtype=torch.int32)

        # 5. pointer-jump to convergence, then relabel via the new roots
        if typed:
            roots, _ = chan.call(ctx, "jump", d, gs.v_mask)
        else:
            roots, _ = common.pj_converge(ctx, d, gs.v_mask,
                                          use_reqresp=False, wire_width=pad)
        new_lab, ovf4 = ask(ctx, lab, gs.v_mask, roots, "relabel")
        new_lab = torch.where(gs.v_mask, new_lab, gid)

        halt = ~got.any(dim=1)
        return {
            "L": new_lab,
            "msf_w": state["msf_w"] + add_w,
            "msf_cnt": state["msf_cnt"] + add_c,
        }, halt, ovf1 | ovf2 | ovf3 | ovf4

    def init(pg):
        assert pg.n < (1 << 24), "ids must be exact in float32"
        w = pg.rows
        return {
            "L": pg.global_ids(),
            "msf_w": torch.zeros(w, dtype=torch.float32, device=pg.device),
            "msf_cnt": torch.zeros(w, dtype=torch.int32, device=pg.device),
        }

    def extract(pg, state):
        total_w = float(state["msf_w"].cpu().numpy().sum())
        total_c = int(state["msf_cnt"].cpu().numpy().sum())
        return {"weight": total_w, "edges": total_c,
                "labels": pg.to_global(state["L"])}

    return VertexProgram(
        name=f"msf:{variant}", init=init, step=step, extract=extract,
        channels=chan, max_steps=max_steps,
        meta={"algorithm": "msf", "variant": variant},
    )
