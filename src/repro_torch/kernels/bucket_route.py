"""Launch wrapper of ``csrc/bucket_route.cu``: stable per-row bucket
ranks on the card (the routed exchange's permutation core; the port of
the Pallas ``bucket_ranks_pallas``)."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

#: the kernel's bucket limit: B + 1 (buckets plus the sentinel) <= 64
MAX_BUCKETS = 64
CHUNK = 1024  # keys per block, fixed in the source

_fn = None
#: launches of the kernel since the last reset (kernels.ops owns resets)
launches = 0


def _launcher():
    global _fn
    if _fn is None:
        fn = build.library("bucket_route").bucket_ranks_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def bucket_ranks_cuda(keys: torch.Tensor, num_buckets: int):
    """``(rank (*B, M) int32, counts (*B, num_buckets) int32)`` for CUDA
    ``keys`` (``(*B, M)`` int32 in ``[0, num_buckets]``), ranked along the
    last axis. Raises above the kernel's bucket limit."""
    nb = num_buckets + 1
    if nb > MAX_BUCKETS:
        raise ValueError(
            f"bucket_ranks kernel supports at most {MAX_BUCKETS - 1} buckets "
            f"plus the sentinel; got num_buckets={num_buckets}")
    if not keys.is_cuda:
        raise ValueError("bucket_ranks_cuda needs a CUDA tensor")
    global launches
    batch, m = tuple(keys.shape[:-1]), keys.shape[-1]
    rows = math.prod(batch)
    k = keys.reshape(rows, m).to(torch.int32).contiguous()
    rank = torch.empty_like(k)
    counts = torch.zeros((rows, nb), dtype=torch.int32, device=k.device)
    if rows and m:
        nchunks = -(-m // CHUNK)
        scratch = torch.empty(rows * nb * nchunks, dtype=torch.int32,
                              device=k.device)
        stream = torch.cuda.current_stream(k.device).cuda_stream
        err = _launcher()(k.data_ptr(), rank.data_ptr(), counts.data_ptr(),
                          scratch.data_ptr(), rows, m, nb, stream)
        if err:
            raise RuntimeError(f"bucket_ranks kernel launch failed: CUDA "
                               f"error {err}")
        launches += 1
    return (rank.reshape(keys.shape),
            counts[:, :num_buckets].reshape(batch + (num_buckets,)))
