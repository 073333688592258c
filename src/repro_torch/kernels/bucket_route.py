"""Launch wrappers of ``csrc/bucket_route.cu``: stable per-row bucket
ranks on the card (the routed exchange's permutation core; the port of
the Pallas ``bucket_ranks_pallas``), and the same ranks with per-lane
bucket histograms for the batched query plane (the port of
``bucket_ranks_lanes_pallas``). Each call is one kernel launch and no
memset: the kernels' scratch lives on here between calls (see
:func:`scratch_of`), and the kernel keeps its own epoch on the device,
so a launch captured into a CUDA graph is right on every replay."""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build, scratch

#: the kernel's bucket limit: B + 1 (buckets plus the sentinel) <= 64
MAX_BUCKETS = 64
#: rows ride on the launch grid's y dimension
MAX_ROWS = 65535
#: the lanes kernel's shared tile, (B + 1) x (Q + 1) int32, must fit this
MAX_LANE_TILE_BYTES = 32768

_fns = None
#: launches of each kernel since the last reset (kernels.ops owns resets)
launches = 0
lane_launches = 0


class _Scratch:
    """The kernels' scratch for one :func:`scratch.key`: ``status``, the
    look-back's status words, tagged with the call's epoch so that no call
    reads another's; ``ctrl``, two words the kernel keeps (the epoch and
    the ticket, and a finished-block count; see ``bucket_route.cu``);
    ``zero``, the rows' finished-tile counts and the lane accumulator,
    which every lanes launch leaves zero. All start zeroed. ``status`` and
    ``zero`` are replaced, zeroed, only when a call needs more; the epoch
    goes on in ``ctrl``, so new zeroed status words never meet it."""

    def __init__(self, device):
        self.device = device
        self.ctrl = torch.zeros(2, dtype=torch.int64, device=device)
        self.status = torch.zeros(0, dtype=torch.int64, device=device)
        self.zero = torch.zeros(0, dtype=torch.int32, device=device)

    def take(self, status_words: int, zero_words: int = 0):
        """``(status, ctrl, zero)`` for a call: at least that many 8-byte
        status words and 4-byte zero words."""
        if self.status.numel() < status_words:
            scratch.check_growth(self.device, "bucket_ranks")
            self.status = torch.zeros(status_words, dtype=torch.int64,
                                      device=self.device)
        if self.zero.numel() < zero_words:
            scratch.check_growth(self.device, "bucket_ranks_lanes")
            self.zero = torch.zeros(zero_words, dtype=torch.int32,
                                    device=self.device)
        return self.status, self.ctrl, self.zero


_scratches: Dict[tuple, _Scratch] = scratch.table()


def scratch_of(device) -> _Scratch:
    """The scratch a launch on ``device`` uses now (see
    :mod:`repro_torch.kernels.scratch`)."""
    k = scratch.key(device)
    if k not in _scratches:
        _scratches[k] = _Scratch(device)
    return _scratches[k]


def device_launches() -> Tuple[int, int]:
    """(``bucket_ranks``, ``bucket_ranks_lanes``) launches since the
    library loaded, as the kernel counts them on the device: launches
    replayed from a captured CUDA graph included. Synchronizes the
    device."""
    return build.device_counters("bucket_route",
                                 "bucket_ranks_device_launches")


def epoch_limit() -> int:
    """The kernels' last epoch before the status words are zeroed."""
    return int(_library()[3]())


def _library():
    global _fns
    if _fns is None:
        lib = build.library("bucket_route")
        plain, lanes, words, limit = (lib.bucket_ranks_launch,
                                      lib.bucket_ranks_lanes_launch,
                                      lib.bucket_ranks_status_words,
                                      lib.bucket_ranks_epoch_limit)
        tail = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
        plain.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_void_p] + tail + [ctypes.c_void_p]
        lanes.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p] + tail + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        plain.restype = lanes.restype = ctypes.c_int
        words.argtypes = tail
        words.restype = ctypes.c_longlong
        limit.argtypes = []
        limit.restype = ctypes.c_uint
        _fns = plain, lanes, words, limit
    return _fns


def _check(num_buckets: int, rows: int, what: str) -> int:
    nb = num_buckets + 1
    if nb > MAX_BUCKETS:
        raise ValueError(
            f"{what} kernel supports at most {MAX_BUCKETS - 1} buckets "
            f"plus the sentinel; got num_buckets={num_buckets}")
    if rows > MAX_ROWS:
        raise ValueError(f"{what} kernel takes at most {MAX_ROWS} rows, got "
                         f"{rows}")
    return nb


def bucket_ranks_cuda(keys: torch.Tensor, num_buckets: int):
    """``(rank (*B, M) int32, counts (*B, num_buckets) int32)`` for CUDA
    ``keys`` (``(*B, M)`` int32 in ``[0, num_buckets]``), ranked along the
    last axis; a key outside that range gets rank 0 and no count. Raises
    above the kernel's bucket and row limits."""
    batch, m = tuple(keys.shape[:-1]), keys.shape[-1]
    rows = math.prod(batch)
    nb = _check(num_buckets, rows, "bucket_ranks")
    if not keys.is_cuda:
        raise ValueError("bucket_ranks_cuda needs a CUDA tensor")
    global launches
    k = keys.reshape(rows, m).to(torch.int32).contiguous()
    rank = torch.empty_like(k)
    if not (rows and m):
        counts = torch.zeros((rows, nb), dtype=torch.int32, device=k.device)
    else:
        plain, _, words, _ = _library()
        counts = torch.empty((rows, nb), dtype=torch.int32, device=k.device)
        stream = torch.cuda.current_stream(k.device).cuda_stream
        status, ctrl, _ = scratch_of(k.device).take(words(rows, m, nb))
        err = plain(k.data_ptr(), rank.data_ptr(), counts.data_ptr(),
                    status.data_ptr(), status.numel(), ctrl.data_ptr(), rows,
                    m, nb, stream)
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
    ``[0, num_buckets]``) and ``lanes`` (``(*B, M, Q)`` bool, or uint8
    0/1, membership, all-False on sentinel rows — the kernel does not read
    them; each row's (M, Q) block dense, the rows read in place wherever
    they lie). A key outside ``[0, num_buckets]`` gets rank 0 and no count.
    Raises above the bucket and row limits or when the (B + 1) x (Q + 1)
    int32 tile exceeds ``MAX_LANE_TILE_BYTES``."""
    batch, m = tuple(keys.shape[:-1]), keys.shape[-1]
    rows = math.prod(batch)
    nb = _check(num_buckets, rows, "bucket_ranks_lanes")
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
    k = keys.reshape(rows, m).to(torch.int32).contiguous()
    lm = lanes.reshape(rows, m, q)
    if lm.stride(2) != 1 or lm.stride(1) != q:
        lm = lm.contiguous()  # rows may lie apart; within a row, (M, Q) dense
    rank = torch.empty_like(k)
    if not (rows and m):
        counts = torch.zeros((rows, nb), dtype=torch.int32, device=k.device)
        lane_counts = torch.zeros((rows, nb, q), dtype=torch.int32,
                                  device=k.device)
    else:
        _, launch, words, _ = _library()
        counts = torch.empty((rows, nb), dtype=torch.int32, device=k.device)
        lane_counts = torch.empty((rows, nb, q), dtype=torch.int32,
                                  device=k.device)
        stream = torch.cuda.current_stream(k.device).cuda_stream
        status, ctrl, zero = scratch_of(k.device).take(
            words(rows, m, nb), rows + rows * nb * q)
        err = launch(k.data_ptr(), lm.data_ptr(), rank.data_ptr(),
                     counts.data_ptr(), lane_counts.data_ptr(),
                     status.data_ptr(), status.numel(), ctrl.data_ptr(),
                     zero.data_ptr(), rows, m, nb, q, lm.stride(0), stream)
        if err:
            raise RuntimeError(f"bucket_ranks_lanes kernel launch failed: "
                               f"CUDA error {err}")
        lane_launches += 1
    return (rank.reshape(keys.shape),
            counts[:, :num_buckets].reshape(batch + (num_buckets,)),
            lane_counts[:, :num_buckets].reshape(
                batch + (num_buckets, q)))
