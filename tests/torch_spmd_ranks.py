"""The per-rank functions of tests/test_torch_spmd.py and the sharded
restore of tests/test_torch_train.py: each takes numpy inputs made by the
test (ranks re-import this module, which imports no JAX), places them on
a gloo CPU mesh, runs the sharded path and returns numpy results, whole
on every rank."""
import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.distributed import context
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.moe_spmd import make_spmd_moe
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as M
from repro_torch.models import params as Pm
from repro_torch.models.config import ModelConfig


def _mesh(shape, dev) -> Mesh:
    torch.set_num_threads(1)
    return Mesh(shape, ("data", "model"), dev.type)


def _np(t):
    from torch.distributed.tensor import DTensor

    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().cpu().numpy()


def moe_layer(rank, world, dev, mesh_shape, cfg_kw, lp, x):
    """``make_spmd_moe`` on one layer's weights, placed as the param
    specs place them (EP: experts over "model"; else expert-TP: ff)."""
    cfg = ModelConfig(**cfg_kw)
    mesh = _mesh(mesh_shape, dev)
    ep = sh.ep_enabled(cfg, mesh)
    w_in = sh.Spec("model") if ep else sh.Spec(None, None, "model")
    w_out = sh.Spec("model") if ep else sh.Spec(None, "model")
    specs = {k: sh.Spec() for k in lp}
    specs.update(moe_w1=w_in, moe_w3=w_in, moe_w2=w_out)
    tlp = sh.distribute(Pm.from_jax(lp, dev), mesh, specs)
    tx = sh.place(torch.as_tensor(x, device=dev),
                  sh.NamedSharding(mesh, sh.Spec()))
    with context.activation_sharding(mesh):
        y = make_spmd_moe(cfg, mesh)(cfg, tlp, tx)
    return dict(y=_np(y), ep=ep, placements=str(tlp["moe_w1"].placements))


def forward(rank, world, dev, mesh_shape, arch, params, tokens,
            cfg_kw=None):
    """The smoke config's (or ``cfg_kw``'s) forward on DTensor params
    (FSDP + TP/EP specs) and data-sharded tokens, with the SPMD MoE."""
    cfg = ModelConfig(**cfg_kw) if cfg_kw else registry.ARCHS[arch].smoke
    mesh = _mesh(mesh_shape, dev)
    tp = sh.distribute(Pm.from_jax(params, dev), mesh,
                       sh.param_pspecs(cfg, mesh))
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}
    with context.activation_sharding(mesh):
        batch = sh.distribute(batch, mesh, sh.batch_pspecs(
            cfg, mesh, batch, tokens.shape[0]))
        logits, _ = M.forward(cfg, tp, batch, moe_impl=make_spmd_moe(
            cfg, mesh) if cfg.moe_experts else None)
    return dict(logits=_np(logits), placements=str(logits.placements))


def serve(rank, world, dev, mesh_shape, cfg_kw, params, prompts, new,
          seed):
    """Sharded serving: params placed by ``param_pspecs(fsdp=False)``, the
    cache by ``cache_pspecs`` (``sharding.init_cache``), the prefill and
    ``new - 1`` greedy decode steps with the SPMD MoE, each step's
    vocabulary-split logits and ``sample``'s tokens; ``sample`` at
    temperature 0.8 on the split prefill logits and on the same logits
    whole (one generator seed); the sharded ``generate``."""
    from repro_torch.serve import decode as D

    cfg = ModelConfig(**cfg_kw)
    mesh = _mesh(mesh_shape, dev)
    tp = sh.distribute(Pm.from_jax(params, dev), mesh,
                       sh.param_pspecs(cfg, mesh, fsdp=False))
    moe = make_spmd_moe(cfg, mesh) if cfg.moe_experts else None
    b, s = prompts.shape
    with torch.no_grad(), context.activation_sharding(mesh):
        cache = sh.init_cache(cfg, mesh, b, s + new, device=dev)
        placed = {"/".join(path): str(t.placements)
                  for path, t in _paths(cache)}
        batch = {"tokens": torch.as_tensor(prompts, device=dev)}
        batch = sh.distribute(batch, mesh, sh.batch_pspecs(cfg, mesh, batch,
                                                           b))
        last, cache = D.make_prefill_step(cfg, moe)(tp, batch, cache)
        tok = D.sample(last)[:, None].to(torch.int32)
        logits, toks = [last], [tok]
        decode = D.make_decode_step(cfg, moe)
        for i in range(new - 1):
            tok, last, cache = decode(tp, cache, tok, s + i)
            logits.append(last)
            toks.append(tok)
        sampled = D.sample(logits[0], 0.8, torch.Generator(
            device=dev).manual_seed(seed))
        whole = D.sample(logits[0].full_tensor(), 0.8, torch.Generator(
            device=dev).manual_seed(seed))
        gen = D.generate(cfg, tp, prompts, new, moe_impl=moe)
    return dict(logits=[_np(x) for x in logits],
                tokens=_np(torch.cat(toks, 1)), sampled=_np(sampled),
                sampled_whole=_np(whole), generated=_np(gen),
                logit_placements=str(logits[0].placements),
                cache_placements=placed)


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    else:
        yield path, tree


def train_step(rank, world, dev, mesh_shape, arch, state, batch, lr):
    """One step of the smoke config from a JAX state (numpy), placed by
    ``train_state_pspecs``, on the data-sharded batch."""
    from repro_torch.train import train_step as tts
    from repro_torch.train.optimizer import AdamW

    cfg = registry.ARCHS[arch].smoke
    mesh = _mesh(mesh_shape, dev)
    opt = AdamW(lr=lr)
    ts = tts.from_jax(state, dev)
    ts = sh.distribute(ts, mesh, sh.train_state_pspecs(cfg, mesh))
    tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    step = tts.make_train_step(cfg, opt, moe_impl=make_spmd_moe(cfg, mesh)
                               if cfg.moe_experts else None)
    with context.activation_sharding(mesh):
        tb = sh.distribute(tb, mesh, sh.batch_pspecs(
            cfg, mesh, tb, next(iter(tb.values())).shape[0]))
        new, metrics = step(ts, tb)
    return dict(loss=float(metrics["loss"]),
                grad_norm=float(metrics["grad_norm"]),
                params=Pm.tree_map(_np, new.params),
                m=Pm.tree_map(_np, new.opt.m), v=Pm.tree_map(_np, new.opt.v),
                step=int(_np(new.opt.step)))


def restore(rank, world, dev, mesh_shape, cfg_kw, ckpt_dir):
    """A checkpoint restored with ``shardings=`` onto the mesh: every leaf
    a DTensor of the spec's placements, gathered back whole."""
    from torch.distributed.tensor import DTensor

    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import train_step as tts
    from repro_torch.train.optimizer import AdamW

    cfg = ModelConfig(**cfg_kw)
    mesh = _mesh(mesh_shape, dev)
    specs = sh.train_state_pspecs(cfg, mesh)
    got = ckpt.restore(ckpt_dir, tts.train_state_specs(cfg, AdamW()),
                       shardings=sh.named(mesh, specs), device=dev)
    leaves = Pm.tree_leaves(got.params)
    placed = all(isinstance(t, DTensor) for t in leaves)
    want = [sh.placements(mesh, s) for s in Pm.tree_leaves(specs.params)]
    return dict(placed=placed,
                placements_ok=all(tuple(t.placements) == w
                                  for t, w in zip(leaves, want)),
                local_bytes=sum(t.to_local().numel() * 4 for t in leaves),
                params=Pm.tree_map(_np, got.params),
                m=Pm.tree_map(_np, got.opt.m),
                step=int(_np(got.opt.step)))


def several(rank, world, dev, calls):
    """Several of the functions above in one spawn: ``calls`` is a list of
    (name, args); returns their results in order."""
    return [globals()[name](rank, world, dev, *args) for name, args in calls]
