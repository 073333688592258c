"""Launch wrappers of ``csrc/bucket_route.cu``: stable per-row bucket
ranks on the card (the routed exchange's permutation core; the port of
the Pallas ``bucket_ranks_pallas``), and the same ranks with per-lane
bucket histograms for the batched query plane (the port of
``bucket_ranks_lanes_pallas``)."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

#: the kernel's bucket limit: B + 1 (buckets plus the sentinel) <= 64
MAX_BUCKETS = 64
CHUNK = 1024  # keys per block, fixed in the source
#: the lanes kernel's shared tile, (B + 1) x (Q + 1) int32, must fit this
MAX_LANE_TILE_BYTES = 32768

_fn = None
_lanes_fn = None
#: launches of each kernel since the last reset (kernels.ops owns resets)
launches = 0
lane_launches = 0


def _launcher():
    global _fn
    if _fn is None:
        fn = build.library("bucket_route").bucket_ranks_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _lanes_launcher():
    global _lanes_fn
    if _lanes_fn is None:
        fn = build.library("bucket_route").bucket_ranks_lanes_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lanes_fn = fn
    return _lanes_fn


def _check_buckets(num_buckets: int, what: str) -> int:
    nb = num_buckets + 1
    if nb > MAX_BUCKETS:
        raise ValueError(
            f"{what} kernel supports at most {MAX_BUCKETS - 1} buckets "
            f"plus the sentinel; got num_buckets={num_buckets}")
    return nb


def bucket_ranks_cuda(keys: torch.Tensor, num_buckets: int):
    """``(rank (*B, M) int32, counts (*B, num_buckets) int32)`` for CUDA
    ``keys`` (``(*B, M)`` int32 in ``[0, num_buckets]``), ranked along the
    last axis. Raises above the kernel's bucket limit."""
    nb = _check_buckets(num_buckets, "bucket_ranks")
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


def bucket_ranks_lanes_cuda(keys: torch.Tensor, lanes: torch.Tensor,
                            num_buckets: int):
    """``(rank (*B, M), counts (*B, num_buckets), lane_counts (*B,
    num_buckets, Q))`` int32 for CUDA ``keys`` (``(*B, M)`` int32 in
    ``[0, num_buckets]``) and ``lanes`` (``(*B, M, Q)`` bool or uint8
    membership, all-False on sentinel rows — not checked here). Raises
    above the bucket limit or when the (B + 1) x (Q + 1) int32 tile
    exceeds ``MAX_LANE_TILE_BYTES``."""
    nb = _check_buckets(num_buckets, "bucket_ranks_lanes")
    batch, m = tuple(keys.shape[:-1]), keys.shape[-1]
    if tuple(lanes.shape[:-1]) != tuple(keys.shape):
        raise ValueError(f"lanes {tuple(lanes.shape)} do not match keys "
                         f"{tuple(keys.shape)} + (Q,)")
    q = lanes.shape[-1]
    if nb * (q + 1) * 4 > MAX_LANE_TILE_BYTES:
        raise ValueError(
            f"bucket_ranks_lanes: a ({nb}, {q} + 1) int32 lane tile exceeds "
            f"the kernel's {MAX_LANE_TILE_BYTES} bytes of shared memory")
    if not (keys.is_cuda and lanes.is_cuda):
        raise ValueError("bucket_ranks_lanes_cuda needs CUDA tensors")
    if lanes.dtype == torch.bool:
        lanes = lanes.view(torch.uint8)
    elif lanes.dtype != torch.uint8:
        raise ValueError(f"lanes must be bool or uint8, got {lanes.dtype}")
    global lane_launches
    rows = math.prod(batch)
    k = keys.reshape(rows, m).to(torch.int32).contiguous()
    lm = lanes.reshape(rows, m, q).contiguous()
    rank = torch.empty_like(k)
    counts = torch.zeros((rows, nb), dtype=torch.int32, device=k.device)
    lane_counts = torch.zeros((rows, nb, q), dtype=torch.int32,
                              device=k.device)
    if rows and m and q:
        nchunks = -(-m // CHUNK)
        scratch = torch.empty(rows * nb * nchunks, dtype=torch.int32,
                              device=k.device)
        stream = torch.cuda.current_stream(k.device).cuda_stream
        err = _lanes_launcher()(
            k.data_ptr(), lm.data_ptr(), rank.data_ptr(), counts.data_ptr(),
            lane_counts.data_ptr(), scratch.data_ptr(), rows, m, nb, q,
            stream)
        if err:
            raise RuntimeError(f"bucket_ranks_lanes kernel launch failed: "
                               f"CUDA error {err}")
        lane_launches += 1
    return (rank.reshape(keys.shape),
            counts[:, :num_buckets].reshape(batch + (num_buckets,)),
            lane_counts[:, :num_buckets].reshape(
                batch + (num_buckets, q)))
