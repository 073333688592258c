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
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build, scratch

#: the narrow kernel's B + 1 (buckets plus the sentinel); above it the wide
#: kernel runs
NARROW_BUCKETS = 64
#: the wide kernel's B + 1: a key + 1 shares a 32-bit register with its
#: rank in the warp (9 bits), and the sign bit stays clear
MAX_BUCKETS = (1 << 22) - 1
#: the narrow kernel's rows ride on the launch grid's y dimension
NARROW_ROWS = 65535
#: the wide kernel's tiles of all rows share the grid's x dimension, one
#: block a tile of TILE_KEYS keys
MAX_BLOCKS = (1 << 31) - 1
TILE_KEYS = 8192
#: warps of a block, each with its own count of every bucket
WARPS = 16
#: shared memory a block may opt in to on an H100 (232,448 bytes, 227 KB);
#: a launch asks its device for the device's own figure
H100_SMEM_OPTIN = 232448
#: bytes of the opt-in left to the narrow kernel's static arrays
STATIC_RESERVE = 8192


class LaunchPlan(NamedTuple):
    """Where one launch keeps its counts (see ``bucket_route.cu``):
    ``wide`` the wide kernel; ``counts_shared`` its (16 + 2) x (B + 1)
    int32 counts in dynamic shared memory, else in ``work_words`` ints of
    global memory, a slab for each block; ``lanes_shared`` the (B + 1) x
    (Q + 1) int32 lane tile in shared memory, else each tile adds its lane
    counts straight into the row's accumulator with integer atomics;
    ``dyn_bytes`` the launch's dynamic shared memory."""

    wide: bool
    counts_shared: bool
    lanes_shared: bool
    dyn_bytes: int
    work_words: int


def launch_plan(num_buckets: int, rows: int, m: int, q: Optional[int] = None,
                smem_optin: int = H100_SMEM_OPTIN) -> LaunchPlan:
    """The launch of ``bucket_ranks`` (``q`` None) or ``bucket_ranks_lanes``
    (``q`` lanes) on ``rows`` rows of ``m`` keys in ``num_buckets``
    buckets, on a device whose blocks may opt in to ``smem_optin`` bytes of
    shared memory; a pure function of its arguments. The narrow kernel
    while B + 1 <= :data:`NARROW_BUCKETS`, rows <= :data:`NARROW_ROWS` and
    its lane tile fits; else the
    wide kernel, with its counts and then its lane tile in shared memory
    as far as they fit. Raises only at the kernels' limits: B + 1 above
    :data:`MAX_BUCKETS`, more than :data:`MAX_BLOCKS` tiles in all."""
    nb = num_buckets + 1
    if nb > MAX_BUCKETS:
        raise ValueError(
            f"bucket kernels take at most {MAX_BUCKETS - 1} buckets plus "
            f"the sentinel (a key + 1 in 22 bits of a slot); got "
            f"num_buckets={num_buckets}")
    tiles = rows * max(1, -(-m // TILE_KEYS))
    if tiles > MAX_BLOCKS:
        raise ValueError(
            f"bucket kernels take at most {MAX_BLOCKS} tiles of "
            f"{TILE_KEYS} keys (one block each); got {rows} rows of {m}")
    room = smem_optin - STATIC_RESERVE
    lane_bytes = 0 if q is None else nb * (q + 1) * 4
    if nb <= NARROW_BUCKETS and rows <= NARROW_ROWS and lane_bytes <= room:
        return LaunchPlan(False, True, q is not None, lane_bytes, 0)
    count_bytes = (WARPS + 2) * nb * 4
    if count_bytes > room:
        return LaunchPlan(True, False, False, 0, tiles * (WARPS + 2) * nb)
    lanes_shared = q is not None and count_bytes + lane_bytes <= room
    return LaunchPlan(True, True, lanes_shared,
                      count_bytes + (lane_bytes if lanes_shared else 0), 0)


_fns = None
_optin: Dict[int, int] = {}
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
        plain, lanes, words, limit, optin = (
            lib.bucket_ranks_launch, lib.bucket_ranks_lanes_launch,
            lib.bucket_ranks_status_words, lib.bucket_ranks_epoch_limit,
            lib.bucket_ranks_smem_optin)
        ll, i, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        tail = [ll, ll, i]  # rows, m, nb
        plain.argtypes = [p] * 4 + [ll, p] + tail + [i, i, ll, p, ll, p]
        lanes.argtypes = [p] * 6 + [ll, p, p] + tail + [
            i, ll, i, i, i, ll, p, ll, p]
        plain.restype = lanes.restype = optin.restype = i
        words.argtypes = tail
        words.restype = ll
        limit.argtypes = optin.argtypes = []
        limit.restype = ctypes.c_uint
        _fns = plain, lanes, words, limit, optin
    return _fns


def _plan_on(device, num_buckets, rows, m, q=None):
    """:func:`launch_plan` with the shared memory ``device`` offers, and
    the wide kernel's global count slabs (this call's alone: each block
    zeroes its own)."""
    idx = device.index if device.index is not None else (
        torch.cuda.current_device())
    if idx not in _optin:
        with torch.cuda.device(idx):
            _optin[idx] = int(_library()[4]())
    plan = launch_plan(num_buckets, rows, m, q, _optin[idx])
    work = torch.empty(plan.work_words, dtype=torch.int32, device=device)
    return plan, work


def bucket_ranks_cuda(keys: torch.Tensor, num_buckets: int):
    """``(rank (*B, M) int32, counts (*B, num_buckets) int32)`` for CUDA
    ``keys`` (``(*B, M)`` int32 in ``[0, num_buckets]``), ranked along the
    last axis; a key outside that range gets rank 0 and no count. Raises
    only at the kernels' limits (:func:`launch_plan`)."""
    batch, m = tuple(keys.shape[:-1]), keys.shape[-1]
    rows, nb = math.prod(batch), num_buckets + 1
    launch_plan(num_buckets, rows, m)
    if not keys.is_cuda:
        raise ValueError("bucket_ranks_cuda needs a CUDA tensor")
    global launches
    k = keys.reshape(rows, m).to(torch.int32).contiguous()
    rank = torch.empty_like(k)
    if not (rows and m):
        counts = torch.zeros((rows, nb), dtype=torch.int32, device=k.device)
    else:
        plain, _, words, _, _ = _library()
        plan, work = _plan_on(k.device, num_buckets, rows, m)
        counts = torch.empty((rows, nb), dtype=torch.int32, device=k.device)
        stream = torch.cuda.current_stream(k.device).cuda_stream
        status, ctrl, _ = scratch_of(k.device).take(words(rows, m, nb))
        err = plain(k.data_ptr(), rank.data_ptr(), counts.data_ptr(),
                    status.data_ptr(), status.numel(), ctrl.data_ptr(), rows,
                    m, nb, int(plan.wide), int(plan.counts_shared),
                    plan.dyn_bytes, work.data_ptr(), plan.work_words, stream)
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
    Raises when ``lanes`` does not match ``keys``, and at the kernels'
    limits (:func:`launch_plan`); a lane tile too large for shared memory
    is counted in global memory."""
    batch, m = tuple(keys.shape[:-1]), keys.shape[-1]
    rows, nb = math.prod(batch), num_buckets + 1
    if tuple(lanes.shape[:-1]) != tuple(keys.shape):
        raise ValueError(f"lanes {tuple(lanes.shape)} do not match keys "
                         f"{tuple(keys.shape)} + (Q,)")
    q = lanes.shape[-1]
    launch_plan(num_buckets, rows, m, q)
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
        _, launch, words, _, _ = _library()
        plan, work = _plan_on(k.device, num_buckets, rows, m, q)
        counts = torch.empty((rows, nb), dtype=torch.int32, device=k.device)
        lane_counts = torch.empty((rows, nb, q), dtype=torch.int32,
                                  device=k.device)
        stream = torch.cuda.current_stream(k.device).cuda_stream
        status, ctrl, zero = scratch_of(k.device).take(
            words(rows, m, nb), rows + rows * nb * q)
        err = launch(k.data_ptr(), lm.data_ptr(), rank.data_ptr(),
                     counts.data_ptr(), lane_counts.data_ptr(),
                     status.data_ptr(), status.numel(), ctrl.data_ptr(),
                     zero.data_ptr(), rows, m, nb, q, lm.stride(0),
                     int(plan.wide), int(plan.counts_shared),
                     int(plan.lanes_shared), plan.dyn_bytes, work.data_ptr(),
                     plan.work_words, stream)
        if err:
            raise RuntimeError(f"bucket_ranks_lanes kernel launch failed: "
                               f"CUDA error {err}")
        lane_launches += 1
    return (rank.reshape(keys.shape),
            counts[:, :num_buckets].reshape(batch + (num_buckets,)),
            lane_counts[:, :num_buckets].reshape(
                batch + (num_buckets, q)))
