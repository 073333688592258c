"""The decoder stack, the port of ``repro.models.model``: a loop over
stacked blocks with train / prefill / decode modes, frontend stubs, and a
pluggable MoE implementation.

The caches are written IN PLACE (PyTorch's idiom): ``forward`` fills or
advances the cache it is given and returns that same dict, where the JAX
function returns new arrays. A caller that wants two independent decode
paths gives each its own cache (``init_cache``)."""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers, mamba
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import tree_map

def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _cast_params(params, dtype):
    """Cast matmul weights to the compute dtype; keep vectors as they
    are. Every stacked block leaf has ndim >= 2 (norm weights, ``dt_bias``,
    ``A_log`` and ``D`` included), so only ``final_norm`` keeps its own
    dtype, as in the JAX package."""
    return tree_map(lambda a: a.to(dtype) if a.ndim >= 2 else a, params)


def init_cache(cfg: ModelConfig, batch: int, s_max: int, dtype=None,
               device: Optional[Union[str, torch.device]] = None):
    """Decode cache tree; leaves stacked over blocks (default device: the
    CUDA device)."""
    dtype = dtype or compute_dtype(cfg)
    dev = resolve_device(device)
    nb = cfg.n_blocks
    caches = {}
    for li, (mixer, _) in enumerate(cfg.block_pattern()):
        if mixer == "attn":
            s_kv = min(s_max, cfg.attn_window) if cfg.attn_window else s_max
            shape = (nb, batch, s_kv, cfg.n_kv_heads, cfg.hd)
            caches[f"l{li}"] = {
                "k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev),
            }
        else:
            kc = cfg.ssm_conv - 1
            caches[f"l{li}"] = {
                "ssm": torch.zeros(
                    (nb, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                    dtype=torch.float32, device=dev,
                ),
                "conv_x": torch.zeros((nb, batch, kc, cfg.d_inner),
                                      dtype=dtype, device=dev),
                "conv_b": torch.zeros((nb, batch, kc, cfg.ssm_state),
                                      dtype=dtype, device=dev),
                "conv_c": torch.zeros((nb, batch, kc, cfg.ssm_state),
                                      dtype=dtype, device=dev),
            }
    return caches


def cache_specs(cfg: ModelConfig, batch: int, s_max: int, dtype=None):
    """The cache tree on the ``meta`` device (shapes and dtypes only)."""
    return init_cache(cfg, batch, s_max, dtype, device="meta")


def embed_input(cfg: ModelConfig, params, batch: Dict[str, Any], dtype,
                start: int = 0):
    """Token embedding + frontend-stub embeddings (precomputed). The
    embeddings come before the tokens. Sinusoidal positions count from
    ``start``, the position of the first input (a decode step's
    ``cache_pos``; the JAX function always counts from 0, so its decode
    steps take position 0's sinusoid)."""
    parts = []
    if batch.get("embeds") is not None:
        parts.append(batch["embeds"].to(dtype))
    if batch.get("tokens") is not None:
        emb = params["embed"].to(dtype)
        # the gather of indexing; its backward sums repeated tokens in a
        # fixed order on the CPU and the card (indexing's backward
        # accumulates in parallel on the CPU, its sums vary run to run)
        parts.append(F.embedding(batch["tokens"], emb))
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    if cfg.pos_embed == "sinusoidal":
        pos = torch.arange(start, start + x.shape[1], device=x.device)
        x = x + layers.sinusoidal_pos(pos, cfg.d_model, dtype)[None]
    return x


def _block_slice(tree, i: int):
    """Block ``i`` of a tree stacked over blocks (views, so a cache slice
    is written through to the stacked cache)."""
    return tree_map(lambda a: a[i], tree)


def _blocks(tree, n: int):
    """The ``n`` blocks of a parameter tree stacked over blocks, taken
    with one ``unbind`` a leaf: the same views as :func:`_block_slice`,
    but the backward stacks the blocks' gradients once, where n ``select``
    backwards would each write a zero gradient of the whole stacked
    leaf."""
    parts = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda t: t[i], parts) for i in range(n)]


def forward(
    cfg: ModelConfig,
    params,
    batch: Dict[str, Any],
    *,
    cache=None,
    cache_pos=None,
    remat: bool = False,
    moe_impl: Optional[Callable] = None,
    logits_f32: bool = True,
    unroll: bool = False,
):
    """Returns (logits (B,S,V), cache_or_None).

    Modes: train (cache=None), prefill (cache given, cache_pos=None),
    decode (cache + cache_pos given; batch carries 1 token). The cache is
    filled (prefill) or advanced (decode) in place and returned. ``remat``
    recomputes each block in the backward pass
    (``torch.utils.checkpoint``); ``unroll`` is accepted for the JAX
    signature and changes nothing (the blocks are a Python loop).
    """
    del unroll
    dt = compute_dtype(cfg)
    p = _cast_params(params, dt)
    moe_fn = moe_impl or layers.moe_layer
    pattern = cfg.block_pattern()
    decode = cache_pos is not None

    start = int(cache_pos) if decode else 0
    x = embed_input(cfg, p, batch, dt, start)
    b, s, d = x.shape
    positions = torch.arange(start, start + s, device=x.device)

    def block_fn(x, bp, bc):
        for li, (mixer, mlp) in enumerate(pattern):
            lp = bp[f"l{li}"]
            lc = bc[f"l{li}"] if bc is not None else None
            h = layers.rms_norm(x, lp["norm_mixer"], cfg.norm_eps)
            if mixer == "attn":
                y, _ = layers.attention(
                    cfg, lp, h, positions=positions, cache=lc,
                    cache_pos=cache_pos,
                )
            else:
                if decode:
                    y, _ = mamba.mamba_decode(cfg, lp, h, lc)
                else:
                    y, _ = mamba.mamba_forward(cfg, lp, h, cache=lc)
            x = x + y
            if mlp != "none":
                h2 = layers.rms_norm(x, lp["norm_mlp"], cfg.norm_eps)
                if mlp == "dense":
                    y2 = layers.dense_mlp(cfg, lp["w1"], lp["w2"],
                                          lp.get("w3"), h2)
                else:
                    y2 = moe_fn(cfg, lp, h2)
                x = x + y2
        return x

    for i, bp in enumerate(_blocks(p["blocks"], cfg.n_blocks)):
        bc = _block_slice(cache, i) if cache is not None else None
        if remat:
            x = checkpoint(block_fn, x, bp, bc, use_reentrant=False)
        else:
            x = block_fn(x, bp, bc)

    x = layers.rms_norm(x, p["final_norm"], cfg.norm_eps)
    head = (p["embed"].T if cfg.tie_embeddings else p["lm_head"]).to(dt)
    logits = x @ head
    if logits_f32:
        logits = logits.float()
    return logits, cache


def _to_module(tree) -> nn.Module:
    return nn.ParameterDict({
        k: _to_module(v) if isinstance(v, dict) else nn.Parameter(
            v, requires_grad=v.is_floating_point())
        for k, v in tree.items()})


def _to_tree(module: nn.ParameterDict):
    return {k: _to_tree(v) if isinstance(v, nn.ParameterDict) else v
            for k, v in module.items()}


class Model(nn.Module):
    """The parameter tree as nested ``nn.ParameterDict``s under the JAX
    paths (``embed``, ``blocks.l0.wq``, ...), with :func:`forward` as its
    ``forward``. ``Model(cfg, params)`` wraps a tree from
    ``params.init_params`` or ``params.from_jax``; ``tree()`` gives the
    tree back (the same tensors)."""

    def __init__(self, cfg: ModelConfig, params):
        super().__init__()
        self.cfg = cfg
        self.params = _to_module(params)

    def tree(self):
        return _to_tree(self.params)

    def forward(self, batch: Dict[str, Any], *, cache=None, cache_pos=None,
                **kw):
        return forward(self.cfg, self.tree(), batch, cache=cache,
                       cache_pos=cache_pos, **kw)
