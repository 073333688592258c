"""Gradient compression — the Aggregator channel's optimized variant, the
port of ``repro.distributed.compression``.

The gradient all-reduce is one typed channel, so its wire format can be
optimized apart from the rest of the program: bf16 halves the bytes of
the data-parallel all-reduce, and error feedback keeps the fp32
accumulation unbiased across steps. As in the JAX package, no train
step calls it yet.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models.params import tree_map


class CompressionState(NamedTuple):
    error: Any  # error-feedback residual, params-shaped (or None)


def init_state(params, error_feedback: bool = True) -> CompressionState:
    if not error_feedback:
        return CompressionState(error=None)
    return CompressionState(error=tree_map(
        lambda p: torch.zeros_like(p, dtype=torch.float32), params))


def compress_grads(grads, state: CompressionState, dtype=torch.bfloat16):
    """Quantize grads to ``dtype`` with error feedback. Returns
    (compressed_grads, new_state); apply before the all-reduce, so it
    moves half the bytes."""
    if state.error is None:
        return tree_map(lambda g: g.to(dtype), grads), state

    def one(g, e):
        gf = g.to(torch.float32) + e
        q = gf.to(dtype)
        return q, gf - q.to(torch.float32)

    pairs = _zip_map(one, grads, state.error)
    return (tree_map(lambda t: t[0], pairs),
            CompressionState(error=tree_map(lambda t: t[1], pairs)))


def decompress_grads(grads):
    return tree_map(lambda g: g.to(torch.float32), grads)


def _zip_map(fn, a, b):
    """``fn`` on the leaves of two trees of the same structure."""
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    return fn(a, b)
