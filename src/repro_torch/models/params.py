"""Parameter tree builder, the port of ``repro.models.params``.

One builder, three uses (same structure guaranteed):
  - init:  make() returns initialized tensors;
  - specs: make() returns tensors on the ``meta`` device (shapes and
    dtypes only, nothing allocated);
  - axes:  make() returns the logical-axis tuple (for a sharding policy).

The tree is nested dicts of tensors with the JAX package's paths: the
blocks' leaves keep their leading ``n_blocks`` dimension (the stacked
layout), so ``model._cast_params`` casts the same leaves as the JAX
forward does.

Logical axes:
  "fsdp"    — weight dim sharded over the data(+pod) axes (ZeRO-3 style)
  "tp"      — weight dim sharded over the model axis (tensor parallel)
  "ep"      — expert dim sharded over the model axis (expert parallel)
  None      — replicated
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig

# leaves above this many elements are drawn in slabs of their leading dim,
# so the float32 draw of a bfloat16 leaf stays small
_DRAW_CHUNK = 1 << 28


def build(cfg: ModelConfig, make: Callable):
    """make(path: str, shape: tuple, axes: tuple, init: str) -> leaf."""
    d, hd = cfg.d_model, cfg.hd
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    p = {}
    p["embed"] = make("embed", (cfg.vocab, d), ("tp", "fsdp"), "embed")
    if not cfg.tie_embeddings:
        p["lm_head"] = make("lm_head", (d, cfg.vocab), ("fsdp", "tp"), "proj_in")
    p["final_norm"] = make("final_norm", (d,), (None,), "one")

    pattern = cfg.block_pattern()
    layers = {}
    for li, (mixer, mlp) in enumerate(pattern):
        lp = {}
        lp["norm_mixer"] = make(f"b{li}.norm_mixer", (cfg.n_blocks, d),
                                (None, None), "one")
        if mixer == "attn":
            lp["wq"] = make(f"b{li}.wq", (cfg.n_blocks, d, hq * hd),
                            (None, "fsdp", "tp"), "proj_in")
            lp["wk"] = make(f"b{li}.wk", (cfg.n_blocks, d, hkv * hd),
                            (None, "fsdp", "tp"), "proj_in")
            lp["wv"] = make(f"b{li}.wv", (cfg.n_blocks, d, hkv * hd),
                            (None, "fsdp", "tp"), "proj_in")
            lp["wo"] = make(f"b{li}.wo", (cfg.n_blocks, hq * hd, d),
                            (None, "tp", "fsdp"), "proj_out")
            if cfg.qkv_bias:
                lp["bq"] = make(f"b{li}.bq", (cfg.n_blocks, hq * hd),
                                (None, "tp"), "zero")
                lp["bk"] = make(f"b{li}.bk", (cfg.n_blocks, hkv * hd),
                                (None, "tp"), "zero")
                lp["bv"] = make(f"b{li}.bv", (cfg.n_blocks, hkv * hd),
                                (None, "tp"), "zero")
        elif mixer == "mamba":
            din, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
            lp["wz"] = make(f"b{li}.wz", (cfg.n_blocks, d, din),
                            (None, "fsdp", "tp"), "proj_in")
            lp["wx"] = make(f"b{li}.wx", (cfg.n_blocks, d, din),
                            (None, "fsdp", "tp"), "proj_in")
            lp["wb"] = make(f"b{li}.wb", (cfg.n_blocks, d, n),
                            (None, "fsdp", None), "proj_in")
            lp["wc"] = make(f"b{li}.wc", (cfg.n_blocks, d, n),
                            (None, "fsdp", None), "proj_in")
            lp["wdt"] = make(f"b{li}.wdt", (cfg.n_blocks, d, h),
                             (None, "fsdp", None), "proj_in")
            lp["dt_bias"] = make(f"b{li}.dt_bias", (cfg.n_blocks, h),
                                 (None, None), "dt_bias")
            lp["conv_x"] = make(f"b{li}.conv_x", (cfg.n_blocks, cfg.ssm_conv, din),
                                (None, None, "tp"), "conv")
            lp["conv_b"] = make(f"b{li}.conv_b", (cfg.n_blocks, cfg.ssm_conv, n),
                                (None, None, None), "conv")
            lp["conv_c"] = make(f"b{li}.conv_c", (cfg.n_blocks, cfg.ssm_conv, n),
                                (None, None, None), "conv")
            lp["A_log"] = make(f"b{li}.A_log", (cfg.n_blocks, h),
                               (None, None), "a_log")
            lp["D"] = make(f"b{li}.D", (cfg.n_blocks, h), (None, None), "one")
            lp["ssm_norm"] = make(f"b{li}.ssm_norm", (cfg.n_blocks, din),
                                  (None, "tp"), "one")
            lp["out_proj"] = make(f"b{li}.out_proj", (cfg.n_blocks, din, d),
                                  (None, "tp", "fsdp"), "proj_out")
        if mlp == "dense":
            ff = cfg.d_ff
            lp["norm_mlp"] = make(f"b{li}.norm_mlp", (cfg.n_blocks, d),
                                  (None, None), "one")
            lp["w1"] = make(f"b{li}.w1", (cfg.n_blocks, d, ff),
                            (None, "fsdp", "tp"), "proj_in")
            lp["w2"] = make(f"b{li}.w2", (cfg.n_blocks, ff, d),
                            (None, "tp", "fsdp"), "proj_out")
            if cfg.activation == "swiglu":
                lp["w3"] = make(f"b{li}.w3", (cfg.n_blocks, d, ff),
                                (None, "fsdp", "tp"), "proj_in")
        elif mlp == "moe":
            e, ff = cfg.moe_experts, cfg.moe_ff
            lp["norm_mlp"] = make(f"b{li}.norm_mlp", (cfg.n_blocks, d),
                                  (None, None), "one")
            lp["router"] = make(f"b{li}.router", (cfg.n_blocks, d, e),
                                (None, "fsdp", None), "proj_in")
            # EP when E divides the model-axis size; else TP inside experts.
            lp["moe_w1"] = make(f"b{li}.moe_w1", (cfg.n_blocks, e, d, ff),
                                (None, "ep", "fsdp", "etp"), "proj_in")
            lp["moe_w2"] = make(f"b{li}.moe_w2", (cfg.n_blocks, e, ff, d),
                                (None, "ep", "etp", "fsdp"), "proj_out")
            if cfg.activation == "swiglu":
                lp["moe_w3"] = make(f"b{li}.moe_w3", (cfg.n_blocks, e, d, ff),
                                    (None, "ep", "fsdp", "etp"), "proj_in")
            if cfg.moe_shared_ff:
                sff = cfg.moe_shared_ff
                lp["shared_w1"] = make(f"b{li}.shared_w1", (cfg.n_blocks, d, sff),
                                       (None, "fsdp", "tp"), "proj_in")
                lp["shared_w2"] = make(f"b{li}.shared_w2", (cfg.n_blocks, sff, d),
                                       (None, "tp", "fsdp"), "proj_out")
                if cfg.activation == "swiglu":
                    lp["shared_w3"] = make(
                        f"b{li}.shared_w3", (cfg.n_blocks, d, sff),
                        (None, "fsdp", "tp"), "proj_in")
                lp["shared_gate"] = make(f"b{li}.shared_gate",
                                         (cfg.n_blocks, d, 1),
                                         (None, "fsdp", None), "proj_in")
        layers[f"l{li}"] = lp
    p["blocks"] = layers
    return p


def tree_map(fn: Callable, tree):
    """``fn`` on every leaf of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree of nested dicts, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def _draw(shape, dtype, device, sample, part=None):
    """``sample(shape)`` (a float32 draw on the generator's device) cast
    to ``dtype`` on ``device``; a large leaf in slabs of its leading dim.
    ``part``, a tuple of slices, keeps only that slice of the leaf: every
    slab is still drawn, so the generator advances as for the whole leaf
    and the slice holds the whole leaf's values."""
    if part is None:
        part = tuple(slice(0, n) for n in shape)
    out = torch.empty(tuple(s.stop - s.start for s in part), dtype=dtype,
                      device=device)
    rows = max(1, _DRAW_CHUNK // max(1, math.prod(shape[1:])))
    if len(shape) < 2 or rows >= shape[0]:
        out.copy_(sample(shape)[part])
    else:
        r0, r1 = part[0].start, part[0].stop
        for i in range(0, shape[0], rows):
            n = min(rows, shape[0] - i)
            slab = sample((n,) + tuple(shape[1:]))
            lo, hi = max(i, r0), min(i + n, r1)
            if lo < hi:
                out[lo - r0:hi - r0].copy_(
                    slab[(slice(lo - i, hi - i),) + part[1:]])
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32,
                device: Optional[Union[str, torch.device]] = None,
                shard: Optional[Callable] = None):
    """Random-init parameters (fp32 master by default) with the JAX
    package's scales: embed and conv 0.02, ``proj_in`` 1/sqrt(fan_in),
    ``proj_out`` that over sqrt(2 * n_layers), ``A_log`` the log of
    U[1, 16), ``dt_bias`` the inverse softplus of a log-uniform dt in
    [1e-3, 1e-1]. The draws come from ``generator`` on its own device (in
    float32, then cast to ``dtype``) and land on ``device`` (default: the
    CUDA device). The values cannot equal the JAX package's: carry those
    across with :func:`from_jax`. ``shard(shape, axes)``, if given,
    returns (slices, wrap): only that slice of each leaf is kept, and
    ``wrap(local)`` is the leaf (``distributed.sharding.init_params``)."""
    dev = resolve_device(device)
    gdev = generator.device

    def normal(scale):
        return lambda shape: (scale * torch.randn(
            shape, generator=generator, device=gdev, dtype=torch.float32))

    def uniform(lo, hi):
        return lambda shape: torch.empty(
            shape, device=gdev, dtype=torch.float32).uniform_(
                lo, hi, generator=generator)

    def make(path, shape, axes, init):
        part, wrap = shard(shape, axes) if shard else (None, lambda t: t)
        local = shape if part is None else tuple(
            s.stop - s.start for s in part)
        if init == "zero":
            return wrap(torch.zeros(local, dtype=dtype, device=dev))
        if init == "one":
            return wrap(torch.ones(local, dtype=dtype, device=dev))
        if init in ("embed", "conv"):
            sample = normal(0.02)
        elif init == "proj_in":
            sample = normal(1.0 / np.sqrt(shape[-2]))
        elif init == "proj_out":
            sample = normal(1.0 / np.sqrt(shape[-2])
                            / np.sqrt(2.0 * cfg.n_layers))
        elif init == "a_log":
            # A in [1, 16) => A_log = log(A)
            u = uniform(1.0, 16.0)
            sample = lambda shape: torch.log(u(shape))
        elif init == "dt_bias":
            # dt in [1e-3, 1e-1] through softplus
            u = uniform(float(np.log(1e-3)), float(np.log(1e-1)))

            def sample(shape):
                dt = torch.exp(u(shape))
                return dt + torch.log(-torch.expm1(-dt))
        else:
            raise ValueError(init)
        return wrap(_draw(shape, dtype, dev, sample, part))

    return build(cfg, make)


def param_specs(cfg: ModelConfig, dtype=torch.float32):
    """The tree on the ``meta`` device: shapes and dtypes, no storage."""
    return build(cfg, lambda path, shape, axes, init:
                 torch.empty(shape, dtype=dtype, device="meta"))


def param_axes(cfg: ModelConfig):
    """Tree of logical-axis tuples matching the param tree."""
    return build(cfg, lambda path, shape, axes, init: axes)


def _from_numpy(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret bits
        t = torch.from_numpy(np.array(a, copy=True).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def from_jax(tree, device, dtype=None):
    """A tree of arrays (numpy, or anything ``np.asarray`` takes, e.g. the
    JAX package's parameters or caches) as tensors on ``device``, in
    ``dtype`` if given, else in the arrays' own dtypes (bfloat16 included,
    bit for bit)."""
    dev = torch.device(device)
    return tree_map(lambda a: _from_numpy(a, dev, dtype), tree)
