"""The one collective that gloo cannot run on CUDA tensors here, staged
through host memory.

Ranks that share a card talk over gloo (NCCL refuses two ranks on one
GPU). On the H100 machine's torch 2.11, gloo runs ``all_reduce``,
``reduce_scatter_tensor`` and ``all_to_all_single`` on CUDA tensors, but
the functional ``all_gather_into_tensor`` that DTensor issues (every
``Shard -> Replicate``, an FSDP gather, ``full_tensor()``) ends the rank
with a segmentation fault. :func:`install` routes that op, for CUDA
tensors only, through host memory: the shard is copied to the host,
gathered there by gloo, and copied back. Every staged call is counted in
:data:`STAGED` (calls and bytes gathered), which the sharded phases
print. Nothing else changes: CPU tensors, NCCL groups and the other
collectives take torch's own path.
"""
from __future__ import annotations

from collections import Counter

STAGED: Counter = Counter()  # "calls", "bytes": staged all-gathers
_LIB = None


def install() -> None:
    """Register the host-staged CUDA kernel of
    ``_c10d_functional.all_gather_into_tensor`` (once a process)."""
    global _LIB
    if _LIB is not None:
        return
    import torch

    def all_gather_into_tensor(t, group_size: int, group_name: str):
        host = torch.ops._c10d_functional.all_gather_into_tensor(
            t.cpu(), group_size, group_name)
        host = torch.ops._c10d_functional.wait_tensor(host)
        STAGED["calls"] += 1
        STAGED["bytes"] += host.numel() * host.element_size()
        return host.to(t.device)

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", all_gather_into_tensor, "CUDA")
    _LIB = lib
