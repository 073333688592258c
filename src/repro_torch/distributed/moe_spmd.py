"""SPMD MoE, the port of ``repro.distributed.moe_spmd``: the routed-expert
layer as an explicit ``local_map`` channel (the counterpart of
``shard_map``).

Tokens stay local to their data shard (the sort by destination expert is
shard-local), experts live on the model axis (EP) or are ff-sliced across
it (expert-TP when the expert count doesn't divide the axis). Each model
shard computes only its share with ``layers.moe_local`` and the outputs
combine with one sum over "model" — the request-respond channel pattern
lowered to a single all-reduce, where DTensor has no sharding rule for
the dispatch's sort, ``searchsorted`` and index assignment at all.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig


def make_spmd_moe(cfg: ModelConfig, mesh: Mesh):
    """``moe_impl`` for ``forward`` on ``mesh``: the router on every model
    rank alike (``layers.moe_route`` under ``local_map``), each rank's
    experts' replies to each (token, choice) pair (``layers.moe_dispatch``
    under ``local_map``: EP experts at ``expert_lo = model rank * E_loc``,
    or every expert's ff slice under expert-TP, whose replies are formed
    in float32), one all-reduce over "model" of the (T * k, d) float32
    replies, and the weighted k-sum of ``layers.moe_combine``. A reply
    comes from one EP rank whole (the sum adds zeros: exact), or as the
    float32 sum of the ff slices rounded once, so the layer rounds as the
    unsharded one does. The gated shared MLP is added as in the JAX
    version; its down projection's float32 partial sums join the replies
    in the one all-reduce."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    ep = sh.ep_enabled(cfg, mesh)
    m = mesh.shape["model"]
    repl = (Replicate(), Replicate())
    if ep:
        w1_pl = w2_pl = (Replicate(), Shard(0))
        e_loc = cfg.moe_experts // m
    else:
        w1_pl, w2_pl = (Replicate(), Shard(2)), (Replicate(), Shard(1))
        e_loc = cfg.moe_experts

    def routed(lp_r, x):
        b, s, d = x.shape
        rows = Shard(0) if b % mesh.dp_size == 0 else Replicate()
        x_pl = tok_pl = (rows, Replicate())
        by_rows = isinstance(rows, Shard)
        w3 = lp_r.get("moe_w3")

        def gates(router, xs):
            bl, sl, _ = xs.shape
            return layers.moe_route(cfg, {"router": router},
                                    xs.reshape(bl * sl, d))

        topi, weights = local_map(
            gates, out_placements=(tok_pl, tok_pl),
            in_placements=(repl, x_pl),
            in_grad_placements=(sh.grad_placements(repl, (by_rows, False)),
                                x_pl),
            device_mesh=mesh.compute, redistribute_inputs=True,
        )(lp_r["router"], x)

        def replies(w1, w2, w3, xs, ti):
            bl, sl, _ = xs.shape
            lo = mesh.compute.get_local_rank(1) * e_loc if ep else 0
            lp_local = {"moe_w1": w1, "moe_w2": w2}
            if w3 is not None:
                lp_local["moe_w3"] = w3
            out, _ = layers.moe_dispatch(
                cfg, lp_local, xs.reshape(bl * sl, d), ti, expert_lo=lo,
                n_local_experts=w1.shape[0], f32_out=not ep)
            return out.float()

        in_pl = (w1_pl, w2_pl, None if w3 is None else w1_pl, x_pl, tok_pl)
        # a replicated input's gradient is a pending sum over the mesh
        # dims the work is split on: "model" always, the data axes when
        # the tokens are sharded
        split = (by_rows, True)
        out = local_map(
            replies, out_placements=((rows, Partial()),),
            in_placements=in_pl,
            in_grad_placements=tuple(
                None if pl is None else sh.grad_placements(pl, split)
                for pl in in_pl[:4]) + (tok_pl,),
            device_mesh=mesh.compute, redistribute_inputs=True,
        )(lp_r["moe_w1"], lp_r["moe_w2"], w3, x, topi)
        return out, weights, tok_pl

    def moe_impl(cfg_, lp, x):
        b, s, d = x.shape
        t, k = b * s, cfg_.moe_top_k
        out, weights, tok_pl = routed(lp, x)
        parts = [out.reshape(t, k * d)]  # each token's k replies, a row
        if cfg_.moe_shared_ff:
            # the shared expert's down projection: its float32 partial
            # sums ride in the same all-reduce as the replies
            h = x @ lp["shared_w1"]
            if cfg_.activation == "swiglu":
                h = F.silu(h) * (x @ lp["shared_w3"])
            else:
                h = F.gelu(h, approximate="tanh")
            parts.append((h.float() @ lp["shared_w2"].float()).reshape(t, d))
        summed = torch.cat(parts, dim=1).redistribute(mesh.compute, tok_pl)
        # a pair no rank answered has an all-zero reply: its weighted
        # contribution is 0, as the unsharded combine's mask makes it
        y = layers.moe_combine(summed[:, :k * d].reshape(t * k, d), weights,
                               None, x.dtype).reshape(b, s, d)
        if cfg_.moe_shared_ff:
            shared = summed[:, k * d:].to(x.dtype).reshape(b, s, d)
            gate = torch.sigmoid((x @ lp["shared_gate"]).float())
            y = y + shared * gate.to(x.dtype)
        return y

    return moe_impl
