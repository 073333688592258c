"""Train step, the port of ``repro.train.train_step``: mixed-precision
forward and backward, per-block remat, gradient accumulation over
microbatches, AdamW update.

The state is updated IN PLACE: the step writes the new parameters and
moments into the tensors of the state it is given (the JAX step donates
them) and returns a state holding the same tensors. Gradients go to each
parameter's ``.grad`` (float32, the master weights' dtype), so at full
width the step holds one gradient tree, not one a microbatch.

On a sharded state (DTensor leaves placed by
``distributed.sharding.train_state_pspecs``, the step run under
``distributed.context.activation_sharding``) the same code runs SPMD:
each gradient is brought to its parameter's placements (a reduce-scatter
or all-reduce over the data axes), the update is in place on each rank's
shards, and the clip's global norm is the whole mesh's. The metrics come
back as plain (replicated) tensors.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.models import model as M
from repro_torch.models import params as P
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.train.optimizer import AdamW, AdamWState


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def cross_entropy(logits, labels, mask=None):
    """Mean CE over valid positions. logits (B,S,V) f32, labels (B,S) int.

    The gold logit is a masked reduction over the vocabulary, as in the
    JAX package (not a gather, whose backward is a scatter)."""
    logz = torch.logsumexp(logits, dim=-1)
    iota = torch.arange(logits.shape[-1], device=logits.device)
    gold = torch.where(iota == labels[..., None].long(), logits,
                       torch.zeros((), dtype=logits.dtype,
                                   device=logits.device)).sum(dim=-1)
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.to(torch.float32)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _replicated(x):
    """A DTensor scalar replicated on every rank (a pending sum reduced),
    so that its backward starts from one, not one a rank."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def _plain(x):
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def make_loss_fn(cfg: ModelConfig, *, remat: bool = True,
                 moe_impl: Optional[Callable] = None):
    """loss_fn(params, batch) -> scalar loss; the frontend prefix (vision
    patches) carries no loss."""
    def loss_fn(params, batch):
        logits, _ = M.forward(cfg, params, batch, remat=remat,
                              moe_impl=moe_impl)
        labels = batch["labels"]
        prefix = logits.shape[1] - labels.shape[1]
        if prefix:
            logits = logits[:, prefix:]
        return _replicated(cross_entropy(logits, labels,
                                         batch.get("loss_mask")))
    return loss_fn


def _split(x, microbatches: int):
    """The microbatches of a batch leaf: contiguous parts of its rows. A
    DTensor leaf is split on each rank (each microbatch takes a
    contiguous part of every rank's rows), so that no microbatch moves
    rows between ranks."""
    from torch.distributed.tensor import DTensor

    b = x.shape[0]
    assert b % microbatches == 0, (b, microbatches)
    if isinstance(x, DTensor):
        loc = _split(x.to_local(), microbatches)
        return [DTensor.from_local(part, x.device_mesh, x.placements,
                                   run_check=False) for part in loc]
    return x.reshape((microbatches, b // microbatches) + tuple(x.shape[1:]))


def _grad(p: torch.Tensor) -> torch.Tensor:
    """``p.grad``, zeros where the loss does not reach ``p`` (the token
    embedding of an audio-frames model): JAX's gradient there. A DTensor
    gradient is brought to its parameter's placements first (a pending
    sum over the data axes reduced: all-reduce, or reduce-scatter onto an
    FSDP shard)."""
    from torch.distributed.tensor import DTensor

    if p.grad is None:
        p.grad = torch.zeros_like(p)
    elif isinstance(p, DTensor) and tuple(p.grad.placements) != tuple(
            p.placements):
        p.grad = p.grad.redistribute(p.device_mesh, p.placements)
    return p.grad


def make_train_step(
    cfg: ModelConfig,
    opt: AdamW,
    *,
    microbatches: int = 1,
    remat: bool = True,
    grad_dtype=torch.float32,
    moe_impl: Optional[Callable] = None,
):
    """Returns train_step(state, batch) -> (state, metrics).

    With microbatches > 1 the global batch's leading dim is split into
    equal parts; the gradients are summed in ``grad_dtype`` (into each
    parameter's ``.grad`` when that is the parameters' dtype) and divided
    by ``microbatches``, and the loss is the mean over microbatches.
    Activation memory is one microbatch's. The state is updated in place
    (see the module docstring). ``moe_impl`` replaces the MoE layer
    (``distributed.moe_spmd.make_spmd_moe`` on a mesh)."""
    loss_fn = make_loss_fn(cfg, remat=remat, moe_impl=moe_impl)

    def grads_of(leaves, params, batch):
        """Loss and each leaf's gradient (summed over microbatches)."""
        if microbatches == 1:
            loss = loss_fn(params, batch)
            loss.backward()
            return loss.detach(), [_grad(p) for p in leaves]
        micro = {k: _split(v, microbatches) for k, v in batch.items()}
        in_grad = all(p.dtype == grad_dtype for p in leaves)
        acc = None
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(microbatches):
            li = loss_fn(params, {k: v[i] for k, v in micro.items()})
            if in_grad:  # accumulate in .grad: g_1 + g_2 + ...
                li.backward()
            else:
                gs = torch.autograd.grad(li, leaves)
                with torch.no_grad():
                    if acc is None:
                        acc = [torch.zeros_like(p, dtype=grad_dtype)
                               for p in leaves]
                    for a, g in zip(acc, gs):
                        a.add_(g.to(grad_dtype))
            loss = loss + li.detach()
        grads = [_grad(p) for p in leaves] if in_grad else acc
        n = torch.tensor(float(microbatches), dtype=torch.float32,
                         device=loss.device)
        with torch.no_grad():
            for g in grads:
                g.div_(n.to(g.dtype))
        return loss / n, grads

    def train_step(state: TrainState, batch):
        params = state.params
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        loss, glist = grads_of(leaves, params, batch)
        for p in leaves:
            p.requires_grad_(False)
        it = iter(glist)
        grads = tree_map(lambda _: next(it), params)
        new_params, new_opt, gnorm = opt.update(grads, state.opt, params)
        for p in leaves:
            p.grad = None
        metrics = {"loss": _plain(loss), "grad_norm": _plain(gnorm),
                   "lr": _plain(opt.schedule(new_opt.step))}
        return TrainState(new_params, new_opt), metrics

    return train_step


def init_train_state(cfg: ModelConfig, opt: AdamW,
                     generator: torch.Generator, device=None,
                     mesh=None, fsdp: bool = True) -> TrainState:
    """Random-init float32 master parameters (drawn from ``generator``,
    placed on ``device``, default the CUDA device) and zero moments. On a
    ``mesh`` (``launch.mesh.Mesh``) the state is DTensors placed by
    ``distributed.sharding.train_state_pspecs``, each rank holding only
    its shards, with the same values."""
    if mesh is None:
        params = P.init_params(cfg, generator, device=device)
        return TrainState(params, opt.init(params))
    from repro_torch.distributed import sharding as sh

    params = sh.init_params(cfg, generator, mesh, fsdp=fsdp, device=device)
    state = opt.init(params)
    step = sh.place(state.step, sh.NamedSharding(mesh, sh.Spec()))
    return TrainState(params, state._replace(step=step))


def train_state_specs(cfg: ModelConfig, opt: AdamW) -> TrainState:
    """The train state on the ``meta`` device: shapes and dtypes only."""
    pspecs = P.param_specs(cfg)
    return TrainState(pspecs, opt.init(pspecs))


def from_jax(state, device) -> TrainState:
    """A JAX ``TrainState`` (its leaves numpy, or anything ``np.asarray``
    takes) as the port's, on ``device``; bfloat16 leaves bit for bit."""
    import numpy as np

    opt = state.opt
    return TrainState(
        P.from_jax(state.params, device),
        AdamWState(step=torch.tensor(int(np.asarray(opt.step)),
                                     dtype=torch.int32,
                                     device=torch.device(device)),
                   m=P.from_jax(opt.m, device), v=P.from_jax(opt.v, device)))
