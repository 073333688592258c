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
    buf[:, at:at + s] = upd.to(buf.dtype)


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
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)

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

    # scores with GQA grouping: (b, hkv, g, sq, sk)
    qg = q.reshape(b, s, hkv, g, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k_full.float())
    scores = scores / math.sqrt(hd)
    mask = _attn_scores_mask(q_pos, k_pos, cfg.attn_window)
    scores = scores + mask[None, None, None]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v_full.float()).to(dt)
    out = out.reshape(b, s, hq * hd)
    return out @ lp["wo"], cache


def dense_mlp(cfg: ModelConfig, w1, w2, w3, x):
    # jax.nn.gelu is the tanh approximation by default; torch's is erf
    h = x @ w1
    if cfg.activation == "swiglu":
        h = F.silu(h) * (x @ w3)
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ w2


def _top_k(logits, k):
    """``lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort; ``torch.topk`` leaves the
    order of ties open)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_local(cfg: ModelConfig, lp, x, stats=None):
    """Sort-based capacity MoE over (T, d) tokens and every expert.

    x: (T, d) tokens; lp["moe_w1"] ... hold all E experts. This is the
    request-respond channel pattern: sort by destination expert,
    capacity-bounded positional buffers, replies combined by weight. The
    sort is stable (the order decides which tokens the capacity drops),
    and the replies are summed over each token's k choices in a fixed
    order, without atomics, so repeated runs on the card are
    bit-identical. ``stats``, a dict if given, gets ``"dropped"``: the
    (token, choice) pairs the capacity dropped (a 0-d tensor, no host
    sync).
    """
    t, d = x.shape
    e = cfg.moe_experts
    k = cfg.moe_top_k
    if t <= e:
        cap = t  # decode-sized batches: never drop (cap=t is collision-free)
    else:
        cap = max(int(np.ceil(t * k / e * cfg.capacity_factor)), 1)

    logits = (x @ lp["router"]).float()  # (T, E)
    topv, topi = _top_k(logits, k)
    weights = torch.softmax(topv, dim=-1)  # normalize over the top-k

    flat_e = topi.reshape(t * k)
    flat_w = weights.reshape(t * k)
    tok = torch.arange(t, device=x.device).repeat_interleave(k)

    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    stok = tok[order]
    starts = torch.searchsorted(
        se, torch.arange(e, device=x.device, dtype=se.dtype))
    rank = torch.arange(t * k, device=x.device) - starts[se]
    fits = rank < cap
    slot = torch.where(fits, se * cap + rank, e * cap)
    if stats is not None:
        stats["dropped"] = t * k - fits.sum()

    # slots of fitting pairs are unique: an index assignment; the rest
    # land on the spare last row, which is cut off
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = x[stok]
    buf = buf[:-1].reshape(e, cap, d)

    h = torch.einsum("ecd,edf->ecf", buf, lp["moe_w1"])
    if cfg.activation == "swiglu":
        h = F.silu(h) * torch.einsum("ecd,edf->ecf", buf, lp["moe_w3"])
    else:
        h = F.gelu(h, approximate="tanh")
    out_buf = torch.einsum("ecf,efd->ecd", h, lp["moe_w2"])

    out_flat = torch.cat([out_buf.reshape(e * cap, d),
                          torch.zeros((1, d), dtype=x.dtype, device=x.device)])
    # back to each pair's (token, choice) position: the sorted pair j is
    # flat pair order[j]
    pair_slot = torch.empty_like(slot)
    pair_slot[order] = slot
    pair_fits = torch.empty_like(fits)
    pair_fits[order] = fits
    contrib = out_flat[pair_slot] * flat_w[:, None].to(x.dtype)
    contrib = torch.where(pair_fits[:, None], contrib, 0).reshape(t, k, d)
    y = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        y = y + contrib[:, j]
    return y


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
