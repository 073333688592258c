"""AdamW with optional gradient clipping and bf16 second-moment storage,
the port of ``repro.train.optimizer`` (m in fp32, v optionally in bf16:
half the optimizer memory of v for a small quality cost, selectable per
config).

The update is IN PLACE (PyTorch's idiom, where the JAX step donates its
buffers): ``update`` writes the new parameters, m and v into the tensors
it is given and returns them. At full width a functional update would
need a second copy of the whole state. Each leaf takes the JAX package's
operations in the JAX package's order, in float32; divisors stay tensors
on the leaf's device (PyTorch's CUDA division by a host scalar multiplies
by its reciprocal, which rounds differently).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.models.params import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32, 0-d
    m: Any  # first moment (params-shaped)
    v: Any  # second moment (params-shaped)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    v_dtype: Optional[str] = None  # e.g. "bfloat16" to halve v memory

    def init(self, params) -> AdamWState:
        """Zero moments beside ``params`` (same devices; v in ``v_dtype``
        if given), step 0."""
        vdt = getattr(torch, self.v_dtype) if self.v_dtype else None
        leaf = tree_leaves(params)[0]
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=leaf.device),
            m=tree_map(lambda p: torch.zeros_like(p, requires_grad=False),
                       params),
            v=tree_map(lambda p: torch.zeros_like(
                p, dtype=vdt or p.dtype, requires_grad=False), params),
        )

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        """lr * min(step / warmup_steps, 1), float32, on step's device."""
        f32 = torch.float32
        warm = torch.minimum(
            step.to(f32) / torch.tensor(float(max(self.warmup_steps, 1)),
                                        dtype=f32, device=step.device),
            torch.ones((), dtype=f32, device=step.device))
        return self.lr * warm

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """One AdamW step. Writes the new parameters, m and v in place (and
        scales ``grads`` in place by the clip factor) and returns
        ``(params, AdamWState(step + 1, m, v), gnorm)``. The global-norm
        clip is min(1, clip / (gnorm + 1e-9)), gnorm over float32 squares
        of every leaf; decoupled weight decay applies to leaves with
        ndim >= 2 only (every stacked block leaf, so only ``final_norm``
        escapes it), as in the JAX package."""
        f32 = torch.float32
        step = state.step + 1
        lr = self.schedule(step)
        dev = step.device
        g_leaves = tree_leaves(grads)

        if self.grad_clip > 0:
            total = 0
            for g in g_leaves:
                total = total + torch.sum(torch.square(g.to(f32)))
            gnorm = torch.sqrt(total)
            scale = torch.minimum(torch.ones((), dtype=f32, device=dev),
                                  self.grad_clip / (gnorm + 1e-9))
            g_leaves = [g.mul_(scale) if g.dtype == f32
                        else g.to(f32) * scale for g in g_leaves]
        else:
            gnorm = torch.zeros((), dtype=f32, device=dev)

        b1, b2 = self.b1, self.b2
        t = step.to(f32)
        bc1 = 1 - torch.tensor(b1, dtype=f32, device=dev) ** t
        bc2 = 1 - torch.tensor(b2, dtype=f32, device=dev) ** t

        for p, g, m, v in zip(tree_leaves(params), g_leaves,
                              tree_leaves(state.m), tree_leaves(state.v)):
            g = g.to(f32)
            mf = m if m.dtype == f32 else m.to(f32)
            mf.mul_(b1).add_(g * (1 - b1))
            vf = v.to(f32) if v.dtype != f32 else v
            vf.mul_(b2).add_((g * g).mul_(1 - b2))
            delta = mf / bc1
            delta.div_((vf / bc2).sqrt_().add_(self.eps))
            if p.ndim >= 2:  # decoupled weight decay on matrices only
                delta.add_(self.weight_decay * p.to(f32))
            delta.mul_(lr)
            if p.dtype == f32:
                p.sub_(delta)
            else:
                p.copy_(p.to(f32) - delta)
            if mf is not m:
                m.copy_(mf)
            if vf is not v:
                v.copy_(vf)
        return params, AdamWState(step=step, m=state.m, v=state.v), gnorm
