"""Mamba2 / SSD (state-space duality) mixer — chunked matmul formulation,
the port of ``repro.models.mamba``.

Within-chunk work is dense matmuls and only the small per-head (P x N)
states recur across chunks (a Python loop over the S/chunk chunks, the
JAX package's ``lax.scan``). The single-token decode path is the exact
SSM recurrence, held against the chunked full-sequence forward. Caches
are written in place, as in :func:`repro_torch.models.layers.attention`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig


def _softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)) with no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _segsum(a):
    """a: (..., L). Returns (..., L, L) with out[i,j] = sum_{j<k<=i} a[k]
    for j < i, 0 on diagonal, -inf above."""
    l = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    lo = torch.tril(torch.ones((l, l), dtype=torch.bool, device=a.device))
    return torch.where(lo, diff, -torch.inf)


def _causal_conv(x, w, state=None):
    """Depthwise causal conv. x (B,S,C), w (K,C). state: (B,K-1,C) past
    inputs for decode continuation. Returns (y, new_state)."""
    b, s, c = x.shape
    k = w.shape[0]
    if state is None:
        state = torch.zeros((b, k - 1, c), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)  # (B, S+K-1, C)
    y = torch.zeros((b, s, c), dtype=torch.float32, device=x.device)
    for i in range(k):
        y = y + xp[:, i: i + s].float() * w[i].float()
    new_state = xp[:, -(k - 1):] if k > 1 else xp[:, :0]
    return F.silu(y).to(x.dtype), new_state


def ssd_chunked(x, dt, a, b_mat, c_mat, chunk: int, init_state=None):
    """SSD scan.

    x:  (B, S, H, P)   inputs per head
    dt: (B, S, H)      discretization (post-softplus)
    a:  (H,)           negative decay rates (=-exp(A_log))
    b_mat, c_mat: (B, S, N)  shared across heads (1 group)
    Returns (y (B,S,H,P), final_state (B,H,P,N)).
    """
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk

    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    bc = b_mat.reshape(bsz, nc, chunk, n)
    cc = c_mat.reshape(bsz, nc, chunk, n)

    da = dtc * a[None, None, None, :]            # (B,C,L,H)
    da_cum = torch.cumsum(da, dim=2)             # (B,C,L,H)
    # intra-chunk: Y_diag = (C B^T * L) (dt x)
    ldec = torch.exp(_segsum(torch.movedim(da, -1, 2)))  # (B,C,H,L,L)
    cb = torch.einsum("bcln,bcmn->bclm", cc, bc)         # (B,C,L,L)
    dtx = xc * dtc[..., None]                            # (B,C,L,H,P)
    y_diag = torch.einsum("bclm,bchlm,bcmhp->bclhp", cb, ldec, dtx)

    # chunk states: contribution of each chunk to its end-state
    decay_to_end = torch.exp(da_cum[:, :, -1:, :] - da_cum)  # (B,C,L,H)
    states = torch.einsum("bcln,bclh,bclhp->bchpn", bc, decay_to_end, dtx)

    # recur across chunks
    chunk_decay = torch.exp(da_cum[:, :, -1, :])  # (B,C,H)
    if init_state is None:
        init_state = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                                 device=x.device)
    prev = init_state.float()
    states = states.float()
    entering = []
    for ci in range(nc):
        entering.append(prev)  # the state ENTERING this chunk
        prev = states[:, ci] + prev * chunk_decay[:, ci, :, None, None]
    final = prev
    entering = torch.stack(entering, dim=1)  # (B,C,H,P,N)

    # inter-chunk: Y_off = C . (decay-from-start * entering_state)
    state_decay = torch.exp(da_cum)  # (B,C,L,H)
    y_off = torch.einsum("bcln,bclh,bchpn->bclhp", cc, state_decay, entering)

    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y.to(x.dtype), final


def _gated_out(cfg: ModelConfig, lp, y, z, x_dtype):
    """Gated RMSNorm (mamba2) and the output projection."""
    yf = y.float() * F.silu(z.float())
    yf = yf * torch.rsqrt(torch.mean(yf * yf, -1, keepdim=True) + cfg.norm_eps)
    return (yf * lp["ssm_norm"]).to(x_dtype) @ lp["out_proj"]


def _write_state(cache, ssm, cx, cb, cc):
    cache["ssm"].copy_(ssm)
    cache["conv_x"].copy_(cx)
    cache["conv_b"].copy_(cb)
    cache["conv_c"].copy_(cc)


def mamba_forward(cfg: ModelConfig, lp, x, *, cache=None, chunk: int = 128):
    """Full-sequence (train/prefill) Mamba2 block. Returns (y, cache): a
    given cache is filled in place with the final SSM state and the conv
    states."""
    b, s, d = x.shape
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state

    z = x @ lp["wz"]
    xin = x @ lp["wx"]
    bproj = x @ lp["wb"]
    cproj = x @ lp["wc"]
    dt = _softplus((x @ lp["wdt"]).float() + lp["dt_bias"])

    xin, conv_x_state = _causal_conv(xin, lp["conv_x"])
    bproj, conv_b_state = _causal_conv(bproj, lp["conv_b"])
    cproj, conv_c_state = _causal_conv(cproj, lp["conv_c"])

    a = -torch.exp(lp["A_log"].float())
    pad = (-s) % chunk
    if pad:
        # zeros past the end: dt = 0 leaves the state as it was
        padf = lambda t: F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
        xin_p, dt_p, b_p, c_p = map(padf, (xin, dt, bproj, cproj))
    else:
        xin_p, dt_p, b_p, c_p = xin, dt, bproj, cproj

    y, final_state = ssd_chunked(
        xin_p.reshape(b, s + pad, h, p),
        dt_p.float(),
        a,
        b_p.float(),
        c_p.float(),
        chunk,
    )
    y = y[:, :s].reshape(b, s, h * p)
    y = y + xin * lp["D"].repeat_interleave(p)[None, None, :]
    out = _gated_out(cfg, lp, y, z, x.dtype)

    if cache is not None:
        _write_state(cache, final_state, conv_x_state, conv_b_state,
                     conv_c_state)
    return out, cache


def mamba_decode(cfg: ModelConfig, lp, x, cache):
    """Single-token recurrence. x: (B, 1, d). Returns (y, cache), the
    cache updated in place."""
    b, _, d = x.shape
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state

    z = x @ lp["wz"]
    xin = x @ lp["wx"]
    bproj = x @ lp["wb"]
    cproj = x @ lp["wc"]
    dt = _softplus((x @ lp["wdt"]).float() + lp["dt_bias"])

    xin, cx = _causal_conv(xin, lp["conv_x"], cache["conv_x"])
    bproj, cb_ = _causal_conv(bproj, lp["conv_b"], cache["conv_b"])
    cproj, cc_ = _causal_conv(cproj, lp["conv_c"], cache["conv_c"])

    a = -torch.exp(lp["A_log"].float())  # (H,)
    da = dt[:, 0] * a[None, :]            # (B,H)
    xh = xin[:, 0].reshape(b, h, p).float()
    bv = bproj[:, 0].float()              # (B,N)
    cv = cproj[:, 0].float()
    dtx = xh * dt[:, 0, :, None]          # (B,H,P)
    st = cache["ssm"] * torch.exp(da)[..., None, None] + torch.einsum(
        "bhp,bn->bhpn", dtx, bv
    )
    y = torch.einsum("bhpn,bn->bhp", st, cv).reshape(b, 1, h * p).to(x.dtype)
    y = y + xin * lp["D"].repeat_interleave(p)[None, None, :]
    out = _gated_out(cfg, lp, y, z, x.dtype)
    _write_state(cache, st, cx, cb_, cc_)
    return out, cache
