"""Serving: prefill + decode steps and a batched generation loop, the
port of ``repro.serve.decode``.

Greedy decoding takes the ``argmax`` and gives the JAX package's tokens.
Sampling draws Gumbel noise from an explicit ``torch.Generator`` (the
Gumbel-max form of ``jax.random.categorical``); the JAX key splitting has
no bitwise counterpart in PyTorch, so sampled tokens cannot equal the JAX
package's. They are the same from one generator seed to the next."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, moe_impl: Optional[Callable] = None):
    def prefill_step(params, batch, cache):
        """batch["tokens"] (B,S) -> (last logits (B,V), cache filled in
        place)."""
        logits, cache = M.forward(cfg, params, batch, cache=cache,
                                  moe_impl=moe_impl)
        return logits[:, -1], cache
    return prefill_step


def _pick(last, temperature: float, generator: Optional[torch.Generator]):
    if temperature > 0:
        u = torch.rand(last.shape, generator=generator, device=last.device,
                       dtype=torch.float32)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        return torch.argmax(last / temperature - torch.log(-torch.log(u)),
                            dim=-1)
    return torch.argmax(last, dim=-1)


def make_decode_step(cfg: ModelConfig, moe_impl: Optional[Callable] = None,
                     temperature: float = 0.0):
    def decode_step(params, cache, tokens, pos, generator=None):
        """tokens (B,1) -> (next (B,1), logits (B,V), cache advanced in
        place)."""
        logits, cache = M.forward(
            cfg, params, {"tokens": tokens}, cache=cache, cache_pos=pos,
            moe_impl=moe_impl,
        )
        last = logits[:, -1]
        nxt = _pick(last, temperature, generator)
        return nxt[:, None].to(torch.int32), last, cache
    return decode_step


@torch.no_grad()
def generate(cfg: ModelConfig, params, prompts, max_new: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             moe_impl: Optional[Callable] = None):
    """Greedy/sampled generation for a (B, S) prompt batch on the
    parameters' device; returns the (B, max_new) int32 new tokens.
    Sampling (``temperature > 0``) draws from ``generator`` (on that
    device), or from a generator seeded 0 if none is given."""
    dev = params["embed"].device
    prompts = torch.as_tensor(prompts, device=dev)
    b, s = prompts.shape
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    cache = M.init_cache(cfg, b, s + max_new, device=dev)
    prefill = make_prefill_step(cfg, moe_impl)
    decode = make_decode_step(cfg, moe_impl, temperature)
    last, cache = prefill(params, {"tokens": prompts}, cache)
    tok = _pick(last, temperature, generator)[:, None].to(torch.int32)
    out = [tok]
    for i in range(max_new - 1):
        tok, _, cache = decode(params, cache, tok, s + i, generator)
        out.append(tok)
    return torch.cat(out, dim=1)
