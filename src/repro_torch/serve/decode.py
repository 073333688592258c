"""Serving: prefill + decode steps and a batched generation loop, the
port of ``repro.serve.decode``.

Greedy decoding takes the ``argmax`` and gives the JAX package's tokens.
Sampling draws Gumbel noise from an explicit ``torch.Generator`` (the
Gumbel-max form of ``jax.random.categorical``); the JAX key splitting has
no bitwise counterpart in PyTorch, so sampled tokens cannot equal the JAX
package's. They are the same from one generator seed to the next.

Sharded serving: the steps take DTensor params and caches (placed by
``distributed.sharding.param_pspecs(fsdp=False)`` and ``cache_pspecs``)
and run under ``distributed.context.activation_sharding``; the logits
they return stay vocab-sharded, and :func:`sample` picks from them
without gathering (B, V): each model shard's best, then the best of
those (ties to the lower index, as ``argmax``)."""
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
        last = last / temperature - torch.log(-torch.log(u))
    return torch.argmax(last, dim=-1)


def sample(last, temperature: float = 0.0,
           generator: Optional[torch.Generator] = None):
    """(B, V) logits -> (B,) token ids: greedy ``argmax``, or Gumbel-max
    at ``temperature`` from ``generator``. DTensor logits sharded on the
    vocabulary stay so: every rank draws the whole (B, V) noise from its
    copy of the generator (the same seed on every rank) and keeps its
    slice, takes its shard's best, and one all-gather over "model" of
    (value, index) pairs picks the best of the shards."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(last, DTensor):
        return _pick(last, temperature, generator)
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor.experimental import local_map

    # all_gather_single is the newer name of all_gather_tensor
    gather = getattr(funcol, "all_gather_single", None) or \
        funcol.all_gather_tensor

    mesh, pl = last.device_mesh, tuple(last.placements)
    split = [i for i, p in enumerate(pl) if isinstance(p, Shard)
             and p.dim == 1 and mesh.size(i) > 1]
    b, v = last.shape
    if temperature > 0:
        u = torch.rand((b, v), generator=generator, device=last.device,
                       dtype=torch.float32)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        last = last / temperature - torch.log(-torch.log(u))
    out_pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1
                   else p for p in pl)

    def best(local):
        if not split:  # the whole vocabulary is here
            return torch.argmax(local, dim=-1)
        md = split[0]
        v_loc = local.shape[1]
        val, idx = torch.max(local, dim=-1)
        idx = idx + mesh.get_local_rank(md) * v_loc
        pairs = torch.stack([val.double(), idx.double()], dim=0)  # (2, b)
        every = gather(pairs, 0, (mesh, md))  # (2 * m, b)
        every = every.reshape(-1, 2, local.shape[0])
        shard = torch.argmax(every[:, 0], dim=0)  # first best shard
        return every[:, 1].gather(0, shard[None])[0].long()

    return local_map(best, out_placements=(out_pl,), in_placements=(pl,),
                     device_mesh=mesh, redistribute_inputs=True)(last)


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
        nxt = sample(last, temperature, generator)
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
    device), or from a generator seeded 0 if none is given. On DTensor
    params (under ``activation_sharding``) the prompts and the cache are
    placed on the context's mesh and the tokens come back whole on every
    rank."""
    from torch.distributed.tensor import DTensor

    dev = params["embed"].device
    prompts = torch.as_tensor(prompts, device=dev)
    b, s = prompts.shape
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    sharded = isinstance(params["embed"], DTensor)
    if sharded:
        from repro_torch.distributed import context, sharding as sh

        mesh = context.current().mesh
        cache = sh.init_cache(cfg, mesh, b, s + max_new, device=dev)
        prompts = sh.place(prompts, sh.NamedSharding(
            mesh, sh.batch_pspecs(cfg, mesh, prompts, b)))
    else:
        cache = M.init_cache(cfg, b, s + max_new, device=dev)
    prefill = make_prefill_step(cfg, moe_impl)
    decode = make_decode_step(cfg, moe_impl, temperature)
    last, cache = prefill(params, {"tokens": prompts}, cache)
    tok = sample(last, temperature, generator)[:, None].to(torch.int32)
    out = [tok]
    for i in range(max_new - 1):
        tok, _, cache = decode(params, cache, tok, s + i, generator)
        out.append(tok)
    out = torch.cat(out, dim=1)
    return out.full_tensor() if sharded else out
