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
from repro_torch.models.layers import reduced_matmul


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


def _scan(xin, dt, a, b_mat, c_mat, chunk: int, p: int):
    """The SSD scan over (B, S) inputs of any S: zeros past the end up to
    a multiple of ``chunk`` (dt = 0 leaves the state as it was), the
    chunked scan, the padding cut. xin (B, S, H*P) -> y (B, S, H*P) and
    the final state (B, H, P, N)."""
    b, s, din = xin.shape
    pad = (-s) % chunk
    if pad:
        padf = lambda t: F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
        xin, dt, b_mat, c_mat = map(padf, (xin, dt, b_mat, c_mat))
    y, final_state = ssd_chunked(
        xin.reshape(b, s + pad, din // p, p), dt.float(), a, b_mat.float(),
        c_mat.float(), chunk)
    return y[:, :s].reshape(b, s, din), final_state


def _recur(xin, dt, a, b_mat, c_mat, state, p: int):
    """One token of the SSM recurrence: xin (B, 1, H*P), dt (B, 1, H),
    b/c (B, 1, N), state (B, H, P, N) -> y (B, 1, H*P), the new state."""
    b, _, din = xin.shape
    h = din // p
    da = dt[:, 0] * a[None, :]            # (B,H)
    xh = xin[:, 0].reshape(b, h, p).float()
    bv = b_mat[:, 0].float()              # (B,N)
    cv = c_mat[:, 0].float()
    dtx = xh * dt[:, 0, :, None]          # (B,H,P)
    st = state * torch.exp(da)[..., None, None] + torch.einsum(
        "bhp,bn->bhpn", dtx, bv
    )
    y = torch.einsum("bhpn,bn->bhp", st, cv).reshape(b, 1, din)
    return y.to(xin.dtype), st


def _ssd(xin, dt, a, b_mat, c_mat, chunk: int, p: int):
    """:func:`_scan`, sharded by heads on DTensors (:func:`_sharded_heads`)."""
    return _sharded_heads(lambda *t: _scan(*t, chunk, p),
                          (xin, dt, a, b_mat, c_mat), p)


def _sharded_heads(fn, args, p: int):
    """``fn(xin, dt, a, b, c[, state])``, the SSM's scan or one step of its
    recurrence. On DTensors (the sharded model) it runs on each rank's
    heads and batch rows under ``local_map``: the scan has no DTensor
    sharding rule that holds in every torch release (torch 2.11 fails on
    its padding, its multi-operand einsums on a shard's strides, and a
    head split that the model axis does not divide), and every head
    scans alone. The heads split over "model" when the axis divides
    them; else every model rank runs all of them."""
    from torch.distributed.tensor import DTensor

    xin = args[0]
    if not isinstance(xin, DTensor):
        return fn(*args) if len(args) == 5 else fn(*args, p)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.context import current
    from repro_torch.distributed.sharding import grad_placements

    mesh = current().mesh
    bsz, h = xin.shape[0], args[2].shape[0]
    rows = Shard(0) if bsz % mesh.dp_size == 0 else Replicate()
    heads = h % mesh.shape["model"] == 0
    on_h = lambda d: (rows, Shard(d) if heads else Replicate())
    in_pl = (on_h(2), on_h(2), (Replicate(), on_h(0)[1]),
             (rows, Replicate()), (rows, Replicate()), on_h(1))[:len(args)]
    split = (isinstance(rows, Shard), heads)
    body = fn if len(args) == 5 else (lambda *t: fn(*t, p))
    return local_map(
        body, out_placements=(on_h(2), on_h(1)), in_placements=in_pl,
        in_grad_placements=tuple(grad_placements(pl, split)
                                 for pl in in_pl),
        device_mesh=mesh.compute, redistribute_inputs=True,
    )(*args)


def _gated_out(cfg: ModelConfig, lp, y, z, x_dtype):
    """Gated RMSNorm (mamba2) and the output projection."""
    yf = y.float() * F.silu(z.float())
    yf = yf * torch.rsqrt(torch.mean(yf * yf, -1, keepdim=True) + cfg.norm_eps)
    return reduced_matmul((yf * lp["ssm_norm"]).to(x_dtype), lp["out_proj"])


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
    y, final_state = _ssd(xin, dt, a, bproj, cproj, chunk, p)
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
    y, st = _sharded_heads(_recur, (xin, dt, a, bproj, cproj,
                                    cache["ssm"]), p)
    y = y + xin * lp["D"].repeat_interleave(p)[None, None, :]
    out = _gated_out(cfg, lp, y, z, x.dtype)
    _write_state(cache, st, cx, cb_, cc_)
    return out, cache
