"""Activation-sharding context, the port of ``repro.distributed.context``.

The model code stays mesh-agnostic; the launcher (dry-run / trainer /
sharded server) activates this context while it runs the model on
DTensors, so that ``constrain()`` pins the few activation shardings that
DTensor's propagation would choose otherwise (notably: keep logits
vocab-sharded through the loss instead of all-gathering (B,S,V)).

Inside the context, plain tensors that meet DTensors (positions, masks,
scalars made on the fly) count as replicated
(``torch.distributed.tensor.experimental.implicit_replication``).

The context is process-wide, where the JAX one is thread-local: the
autograd engine runs the backward of CUDA tensors, and so each block's
recomputation under remat, on a thread of its own, and the recomputed
block must see the mesh the forward saw.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

from repro_torch.launch.mesh import Mesh

_CTX: Optional["ShardCtx"] = None


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    mesh: Mesh
    dp: Tuple[str, ...]   # data-parallel axes ("pod","data") / ("data",)
    tp: str = "model"
    seq_parallel: bool = False  # shard the residual stream's seq dim on tp


def current() -> Optional[ShardCtx]:
    return _CTX


DEFAULT_SEQ_PARALLEL = False  # flipped by launchers (--seq-parallel)


@contextlib.contextmanager
def activation_sharding(mesh: Mesh, seq_parallel=None):
    from torch.distributed.tensor.experimental import implicit_replication

    if seq_parallel is None:
        seq_parallel = DEFAULT_SEQ_PARALLEL
    global _CTX
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    prev = _CTX
    _CTX = ShardCtx(mesh=mesh, dp=dp, seq_parallel=seq_parallel)
    try:
        with implicit_replication():
            yield _CTX
    finally:
        _CTX = prev


def constrain(x, *logical):
    """logical entries: 'dp' (batch), 'tp' (model axis), None. Only applies
    to dims that divide the axis size; no-op outside the context or on a
    plain tensor. Otherwise a ``redistribute`` of the DTensor to the
    mapped placements (a collective where they differ)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding as sh

    ctx = current()
    if ctx is None or not isinstance(x, DTensor):
        return x
    axes = []
    for dim, l in zip(x.shape, logical):
        if l == "dp":
            n = sh.axis_size(ctx.mesh, ctx.dp)
            axes.append(ctx.dp if dim % n == 0 else None)
        elif l == "tp":
            axes.append(ctx.tp if dim % ctx.mesh.shape[ctx.tp] == 0 else None)
        else:
            axes.append(None)
    want = sh.placements(ctx.mesh, sh.Spec(*axes))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(ctx.mesh.compute, want)


def residual_spec():
    """Logical spec for the (B, S, D) residual stream: seq-parallel shards
    the sequence dim over the model axis (Megatron-SP — norms/residuals
    compute on 1/TP of the tokens and the TP all-reduce becomes
    reduce-scatter + all-gather pairs)."""
    ctx = current()
    if ctx is not None and ctx.seq_parallel:
        return ("dp", "tp", None)
    return ("dp", None, None)
