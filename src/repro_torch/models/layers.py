"""Core layers, the port of ``repro.models.layers``: RMSNorm, RoPE, GQA
attention (full + sliding window + decode cache), dense MLP, MoE
(sort-based capacity dispatch).

All functions are shape-polymorphic over (B, S, ...) and have explicit
single-token decode paths, held against the full-sequence forward. The
products are the JAX package's ``@``/``einsum`` as ``torch.matmul``/
``torch.einsum``; attention is computed as there (float32 scores, an
additive mask, softmax), not through ``scaled_dot_product_attention``.
Caches are written in place (see :func:`attention`).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

NEG_INF = -1e30


def rms_norm(x, w, eps):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w).to(dt)


def sinusoidal_pos(positions, dim, dtype):
    """(S,) -> (S, dim) classic transformer sinusoids."""
    half = dim // 2
    freq = torch.exp(-np.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[:, None].float() * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def rope_tables(positions, rot_dim, theta):
    """positions (..., S) -> cos/sin (..., S, rot_dim/2)."""
    freq = theta ** (-torch.arange(0, rot_dim, 2, dtype=torch.float32,
                                   device=positions.device) / rot_dim)
    ang = positions[..., None].float() * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin, mode: str):
    """x: (B, S, H, hd). mode 'standard' rotates all dims (half-split
    layout); mode '2d' rotates only the first half of head dims
    (partial rotary, ChatGLM-style)."""
    if mode == "none":
        return x
    hd = x.shape[-1]
    rot = hd if mode == "standard" else hd // 2
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    r1 = x1 * c - x2 * s
    r2 = x2 * c + x1 * s
    return torch.cat([r1, r2, xp.to(r1.dtype)], dim=-1).to(x.dtype)


def _attn_scores_mask(q_pos, k_pos, window):
    """(..., Sq, Sk) additive mask: causal + optional sliding window."""
    ok = (k_pos[None, :] <= q_pos[:, None]) & (k_pos[None, :] >= 0)
    if window > 0:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    return torch.where(ok, 0.0, NEG_INF)


def _write(buf, upd, at: int, what: str):
    """``buf[:, at:at + S] = upd`` in place. The JAX ``dynamic_update_slice``
    clamps a write that runs past the end (it would land on earlier
    slots); the port refuses it, since no decode loop writes there."""
    s, s_max = upd.shape[1], buf.shape[1]
    if at < 0 or at + s > s_max:
        raise ValueError(
            f"{what}: writing positions [{at}, {at + s}) into a cache of "
            f"{s_max} slots; size the cache for the prompt plus every new "
            f"token (init_cache(cfg, batch, s_max))")
    if _seq_sharded(buf):
        _write_seq_sharded(buf, upd, at)
    else:
        buf[:, at:at + s] = upd.to(buf.dtype)


def _seq_sharded(buf) -> bool:
    from torch.distributed.tensor import DTensor, Shard

    return isinstance(buf, DTensor) and any(
        isinstance(p, Shard) and p.dim == 1 for p in buf.placements)


def _write_seq_sharded(buf, upd, at: int):
    """:func:`_write` into a DTensor cache sharded on its sequence dim (the
    sequence-parallel decode cache): each rank writes the positions of
    ``[at, at + S)`` that its shard holds, in place (a slice of a sharded
    dim is a copy in DTensor, which would drop the write)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map

    mesh, pl = buf.device_mesh, tuple(buf.placements)
    _, offset = compute_local_shape_and_global_offset(buf.shape, mesh, pl)
    lo = offset[1]
    upd_pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1
                   else p for p in pl)

    def write(local, u):
        a, b = max(at, lo), min(at + u.shape[1], lo + local.shape[1])
        if a < b:
            local[:, a - lo:b - lo] = u[:, a - at:b - at].to(local.dtype)
        return local

    local_map(write, out_placements=(pl,), in_placements=(pl, upd_pl),
              device_mesh=mesh, redistribute_inputs=True)(buf, upd)


def attention(cfg: ModelConfig, lp, x, *, positions, cache=None,
              cache_pos=None):
    """GQA attention.

    Train/prefill: cache=None or a cache dict to FILL (prefill).
    Decode: x is (B, 1, d); cache holds k/v; cache_pos (an int or a 0-d
    tensor) is the write index. Returns (out, cache): the cache's tensors
    are written IN PLACE (PyTorch's idiom; the JAX function returns new
    arrays), so the returned dict is the one given. A write past the end
    of a full-attention cache raises where the JAX function would clamp.
    """
    b, s, d = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = hq // hkv
    dt = x.dtype

    q = x @ lp["wq"]
    k = x @ lp["wk"]
    v = x @ lp["wv"]
    if cfg.qkv_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    q = _whole_heads(q, hq).reshape(b, s, hq, hd)
    k = _whole_heads(k, hkv).reshape(b, s, hkv, hd)
    v = _whole_heads(v, hkv).reshape(b, s, hkv, hd)

    rot = hd if cfg.rope == "standard" else hd // 2
    if cfg.rope != "none":
        cos, sin = rope_tables(positions, rot, cfg.rope_theta)
        cos, sin = cos[None], sin[None]  # (1, S, rot/2)
        q = apply_rope(q, cos, sin, cfg.rope)
        k = apply_rope(k, cos, sin, cfg.rope)

    if cache is not None and cache_pos is not None:
        # decode: write this step's k/v into the (ring) cache
        pos = int(cache_pos)
        s_max = cache["k"].shape[1]
        widx = pos % s_max if cfg.attn_window > 0 else pos
        _write(cache["k"], k, widx, "attention decode")
        _write(cache["v"], v, widx, "attention decode")
        k_full, v_full = cache["k"], cache["v"]
        slots = torch.arange(s_max, device=x.device)
        if cfg.attn_window > 0:
            k_pos = pos - ((widx - slots) % s_max)
        else:
            k_pos = slots
        q_pos = positions
    elif cache is not None:
        # prefill: fill cache positions [0, s)
        s_max = cache["k"].shape[1]
        if cfg.attn_window > 0 and s > s_max:
            # ring invariant: position p lives at slot p % s_max
            _write(cache["k"], torch.roll(k[:, -s_max:], s % s_max, 1), 0,
                   "attention prefill")
            _write(cache["v"], torch.roll(v[:, -s_max:], s % s_max, 1), 0,
                   "attention prefill")
        else:
            _write(cache["k"], k, 0, "attention prefill")
            _write(cache["v"], v, 0, "attention prefill")
        k_full, v_full = k, v
        q_pos = positions
        k_pos = positions
    else:
        k_full, v_full = k, v
        q_pos = positions
        k_pos = positions

    out = _attend(q, k_full, v_full, q_pos, k_pos, cfg.attn_window, g)
    return reduced_matmul(out, lp["wo"]), cache


def _whole_heads(x, heads: int):
    """A (B, S, heads * hd) projection whose last dim is split over the
    model axis in parts that cut heads apart (24 heads over 16 ranks) is
    gathered over that axis first: a head is computed whole on one rank.
    Anything else is returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    pl = list(x.placements)
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == x.ndim - 1 and \
                heads % x.device_mesh.size(i):
            pl[i] = Replicate()
    return x if pl == list(x.placements) else x.redistribute(
        x.device_mesh, pl)


def _scores_out(q, k, v, q_pos, k_pos, window: int, g: int):
    """Softmax attention with GQA grouping: q (b, sq, hkv * g, hd), k/v
    (b, sk, hkv, hd) -> (b, sq, hkv * g * hd), in float32."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, g, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    scores = scores / math.sqrt(hd)
    mask = _attn_scores_mask(q_pos, k_pos, window)
    scores = scores + mask[None, None, None]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float()).to(q.dtype)
    return out.reshape(b, s, hq * hd)


def _attend(q, k, v, q_pos, k_pos, window: int, g: int):
    """:func:`_scores_out`; on DTensors (the sharded model) it runs on each
    rank's batch rows and query heads under ``local_map``: the heads split
    over "model" when the query heads divide it, each rank taking the kv
    heads its query heads read (all of them where the kv heads do not
    divide the axis); the keys and values of a sequence-sharded cache are
    gathered first. The heads are flattened inside, so that the
    gradient of the (b, sq, hq * hd) output may come back split over
    "model" however the heads fall. DTensor's einsum rules are not relied
    on (torch 2.11's fail on these grouped products)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(q, DTensor):
        return _scores_out(q, k, v, q_pos, k_pos, window, g)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.context import current
    from repro_torch.distributed.sharding import grad_placements

    mesh = current().mesh
    m = mesh.shape["model"]
    b, _, hq, _ = q.shape
    hkv = k.shape[2]
    rows = Shard(0) if b % mesh.dp_size == 0 else Replicate()
    q_split, kv_split = hq % m == 0, hkv % m == 0 and hq % m == 0
    q_pl = (rows, Shard(2) if q_split else Replicate())
    kv_pl = (rows, Shard(2) if kv_split else Replicate())
    out_pl = q_pl  # (b, sq, hq * hd): the heads stay split on dim 2

    def local(ql, kl, vl):
        if kv_split or not q_split:
            return _scores_out(ql, kl, vl, q_pos, k_pos, window, g)
        # this rank's query heads and the kv head each of them reads
        hq_l = ql.shape[2]
        lo = mesh.compute.get_local_rank(1) * hq_l
        kv_of = (lo + torch.arange(hq_l, device=ql.device)) // g
        return _scores_out(ql, kl[:, :, kv_of], vl[:, :, kv_of], q_pos,
                           k_pos, window, 1)

    split = (isinstance(rows, Shard), q_split)
    return local_map(
        local, out_placements=(out_pl,), in_placements=(q_pl, kv_pl, kv_pl),
        in_grad_placements=(grad_placements(q_pl, split),
                            grad_placements(kv_pl, split),
                            grad_placements(kv_pl, split)),
        device_mesh=mesh.compute, redistribute_inputs=True,
    )(q, k, v)


def reduced_matmul(x, w):
    """``x @ w``. On DTensors whose product sums over a dim that "model"
    splits (a row-parallel product: the attention's output projection,
    the MLP's down projection), each rank's partial sums are formed in
    float32 and summed over "model" in float32, and the sum is rounded to
    ``x``'s dtype once, as the unsharded product rounds its float32
    accumulator once: in bfloat16 a sum of rounded partials strays by
    some 2^-9 a product, and a MoE's top-k and capacity amplify that."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(w, DTensor) or not any(
            isinstance(p, Shard) and p.dim == w.ndim - 2
            for p in w.placements):
        return x @ w
    y = x.float() @ w.float()
    y = y.redistribute(y.device_mesh, tuple(
        Replicate() if isinstance(p, Partial) else p for p in y.placements))
    return y.to(x.dtype)


def dense_mlp(cfg: ModelConfig, w1, w2, w3, x):
    # jax.nn.gelu is the tanh approximation by default; torch's is erf
    h = x @ w1
    if cfg.activation == "swiglu":
        h = F.silu(h) * (x @ w3)
    else:
        h = F.gelu(h, approximate="tanh")
    return reduced_matmul(h, w2)


def _top_k(logits, k):
    """``lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort; ``torch.topk`` leaves the
    order of ties open)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(cfg: ModelConfig, lp, x):
    """The router: x (T, d) -> the top-k experts a token (T, k) and their
    weights (T, k), softmax-normalized over the top-k in float32."""
    logits = (x @ lp["router"]).float()  # (T, E)
    topv, topi = _top_k(logits, cfg.moe_top_k)
    return topi, torch.softmax(topv, dim=-1)


def moe_dispatch(cfg: ModelConfig, lp, x, topi, *, expert_lo: int = 0,
                 n_local_experts=None, stats=None, f32_out: bool = False):
    """The experts' replies to each (token, choice) pair: (T * k, d), 0
    where the pair's expert is another shard's or the capacity dropped
    the pair, and the (T * k,) mask of the pairs that got a reply. The
    capacity is counted from every expert's T * k / E. With ``f32_out``
    the reply products are formed in float32 (from the inputs' values:
    an expert-TP shard's partial sums, reduced before rounding)."""
    t, d = x.shape
    e = cfg.moe_experts
    k = cfg.moe_top_k
    e_loc = (n_local_experts if n_local_experts is not None
             else lp["moe_w1"].shape[0])
    if t <= e:
        cap = t  # decode-sized batches: never drop (cap=t is collision-free)
    else:
        cap = max(int(np.ceil(t * k / e * cfg.capacity_factor)), 1)

    flat_e = topi.reshape(t * k)
    tok = torch.arange(t, device=x.device).repeat_interleave(k)

    mine = (flat_e >= expert_lo) & (flat_e < expert_lo + e_loc)
    e_rel = torch.where(mine, flat_e - expert_lo, e_loc)
    order = torch.argsort(e_rel, stable=True)
    se = e_rel[order]
    stok = tok[order]
    starts = torch.searchsorted(
        se, torch.arange(e_loc + 1, device=x.device, dtype=se.dtype))
    rank = torch.arange(t * k, device=x.device) - starts[se]
    fits = (se < e_loc) & (rank < cap)
    slot = torch.where(fits, se * cap + rank, e_loc * cap)
    if stats is not None:
        stats["dropped"] = mine.sum() - fits.sum()

    # slots of fitting pairs are unique: an index assignment; the rest
    # land on the spare last row, which is cut off
    buf = torch.zeros((e_loc * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = x[stok]
    buf = buf[:-1].reshape(e_loc, cap, d)

    w1, w2 = lp["moe_w1"], lp["moe_w2"]
    h = torch.einsum("ecd,edf->ecf", buf, w1)
    if cfg.activation == "swiglu":
        h = F.silu(h) * torch.einsum("ecd,edf->ecf", buf, lp["moe_w3"])
    else:
        h = F.gelu(h, approximate="tanh")
    if f32_out:
        out_buf = torch.einsum("ecf,efd->ecd", h.float(), w2.float())
    else:
        out_buf = torch.einsum("ecf,efd->ecd", h, w2)

    out_flat = torch.cat([out_buf.reshape(e_loc * cap, d),
                          torch.zeros((1, d), dtype=out_buf.dtype,
                                      device=x.device)])
    # back to each pair's (token, choice) position: the sorted pair j is
    # flat pair order[j]
    pair_slot = torch.empty_like(slot)
    pair_slot[order] = slot
    pair_fits = torch.empty_like(fits)
    pair_fits[order] = fits
    return out_flat[pair_slot], pair_fits


def moe_combine(replies, weights, fits, dtype):
    """Each token's replies weighted and summed over its k choices in a
    fixed order (no atomics): replies (T * k, d), weights (T, k), fits
    (T * k,) or None (every pair's reply as it is) -> (T, d) in
    ``dtype``."""
    t, k = weights.shape
    contrib = replies.to(dtype) * weights.reshape(t * k)[:, None].to(dtype)
    if fits is not None:
        contrib = torch.where(fits[:, None], contrib, 0)
    contrib = contrib.reshape(t, k, -1)
    y = torch.zeros_like(contrib[:, 0])
    for j in range(k):
        y = y + contrib[:, j]
    return y


def moe_local(cfg: ModelConfig, lp, x, *, expert_lo: int = 0,
              n_local_experts=None, stats=None):
    """Sort-based capacity MoE over LOCAL tokens and LOCAL experts:
    :func:`moe_route`, :func:`moe_dispatch`, :func:`moe_combine`.

    x: (T, d) tokens; lp["moe_w1"] ... hold the local slice of experts
    (E_loc, d, ff_loc): experts ``expert_lo .. expert_lo + E_loc`` under
    expert parallelism, every expert's ff slice under expert-TP (see
    ``repro_torch.distributed.moe_spmd``, whose caller sums the shards'
    outputs over the model axis). Pairs routed to another shard's experts
    go to the spare row and add nothing. This is the request-respond
    channel pattern: sort by destination expert, capacity-bounded
    positional buffers, replies combined by weight. The sort is stable
    (the order decides which tokens the capacity drops), and the replies
    are summed over each token's k choices in a fixed order, without
    atomics, so repeated runs on the card are bit-identical. ``stats``, a
    dict if given, gets ``"dropped"``: this shard's (token, choice) pairs
    that the capacity dropped (a 0-d tensor, no host sync).
    """
    topi, weights = moe_route(cfg, lp, x)
    replies, fits = moe_dispatch(cfg, lp, x, topi, expert_lo=expert_lo,
                                 n_local_experts=n_local_experts,
                                 stats=stats)
    return moe_combine(replies, weights, fits, x.dtype)


def moe_layer(cfg: ModelConfig, lp, x, stats=None):
    """MoE over (B, S, d) — local (single-shard) form."""
    b, s, d = x.shape
    y = moe_local(cfg, lp, x.reshape(b * s, d), stats=stats)
    y = y.reshape(b, s, d)
    if cfg.moe_shared_ff:
        shared = dense_mlp(
            cfg, lp["shared_w1"], lp["shared_w2"], lp.get("shared_w3"), x
        )
        gate = torch.sigmoid((x @ lp["shared_gate"]).float())
        y = y + shared * gate.to(x.dtype)
    return y
