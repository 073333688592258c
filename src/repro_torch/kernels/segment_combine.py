"""Launch wrapper of ``csrc/segment_combine.cu``: the sorted-segment
combine on the card (the scatter-combine hot loop; the port of the
Pallas ``segment_combine_pallas``). Two kernels a call and no memset;
the one scratch kept between calls, the chunk table, is zero between
them, so a launch captured into a CUDA graph is right on every
replay."""
from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import build, scratch

_OPS = {"sum": 0, "min": 1, "max": 2, "prod": 3, "min_by_first": 4}
_DTYPES = {torch.float32: 0, torch.int32: 1}
#: entries of a tile, one block each (256 threads x 8 entries)
TILE = 2048
#: columns a group of the multi-column path (its last group may hold 4)
GROUP = 8


class LaunchPlan(NamedTuple):
    """What ``segment_combine.cu`` launches for one call: ``path``
    ``"single"`` (one column scanned at a time: D = 1, ``min_by_first``,
    and D > 1 where the vector path cannot go) or ``"vector"`` (D > 1,
    D % 4 == 0, values and output 16-byte aligned: groups of ``group``
    columns read as 16-byte vectors); ``tail``, the widths of the groups
    after the last whole group; ``scratch_words``, the 4-byte words of the
    call's tile partials."""

    path: str
    group: int
    tail: Tuple[int, ...]
    scratch_words: int


def launch_plan(rows: int, e: int, d: int, op: str,
                aligned: bool) -> LaunchPlan:
    """The launch of the combine ``op`` (a name of ``_OPS``; bool ``or``
    runs as ``max``) on ``rows`` rows of ``e`` entries of ``d`` columns,
    ``aligned`` if the values and the output start 16-byte aligned; a
    pure function of its arguments, the rule of the C dispatch
    (``takes_groups``, ``group_width``, ``segment_combine_scratch_words``;
    the card tests hold the two to each other through the kernels' own
    launch counts)."""
    if op not in _OPS:
        raise ValueError(f"segment_combine has no op {op!r}")
    cells = rows * max(1, -(-e // TILE))
    if d == 1 or op == "min_by_first":
        words = 2 if op == "min_by_first" else d
        return LaunchPlan("single", 1, (), cells * (2 + 2 * words))
    words = -(-2 * cells // 4) * 4 + cells * 2 * d
    if not (aligned and d % 4 == 0):
        return LaunchPlan("single", 1, (), words)
    return LaunchPlan("vector", GROUP, (4,) if d % GROUP else (), words)


_fns = None
#: launches of the kernel since the last reset (kernels.ops owns resets)
launches = 0


class _Chunks:
    """The chunk table of one :func:`scratch.key`: a mark per chunk of a
    long gap of empty segments, set by the kernel's first pass and stored
    and cleared by its second, so the table is zero between launches.
    Zeroed when made; replaced, zeroed, only when a call needs more
    words."""

    def __init__(self, device):
        self.device = device
        self.table = torch.zeros(0, dtype=torch.int32, device=device)

    def take(self, words: int) -> torch.Tensor:
        """The table for a launch: at least ``words`` words, all zero."""
        if self.table.numel() < words:
            scratch.check_growth(self.device, "segment_combine")
            self.table = torch.zeros(max(words, 1), dtype=torch.int32,
                                     device=self.device)
        return self.table


_chunks: Dict[tuple, _Chunks] = scratch.table()


def chunks_of(device) -> _Chunks:
    """The chunk table a launch on ``device`` uses now (see
    :mod:`repro_torch.kernels.scratch`)."""
    k = scratch.key(device)
    if k not in _chunks:
        _chunks[k] = _Chunks(device)
    return _chunks[k]


def device_launches() -> Tuple[int, int]:
    """(first, second) kernel launches since the library loaded, as the
    kernels count them on the device: launches replayed from a captured
    CUDA graph included. Each call launches one of each. Synchronizes the
    device."""
    return build.device_counters("segment_combine",
                                 "segment_combine_device_launches")


def group_launches() -> Tuple[int, int]:
    """Of :func:`device_launches`, those of the multi-column path's two
    kernels (the vector path of :func:`launch_plan`), counted the same
    way. Synchronizes the device."""
    return build.device_counters("segment_combine",
                                 "segment_combine_group_launches")


def group_columns() -> int:
    """The C library's columns a group of the multi-column path."""
    read = build.library("segment_combine").segment_combine_group_columns
    read.restype = ctypes.c_int
    return int(read())


def _library():
    global _fns
    if _fns is None:
        lib = build.library("segment_combine")
        launch, words, chunk_words = (lib.segment_combine_launch,
                                      lib.segment_combine_scratch_words,
                                      lib.segment_combine_chunk_words)
        launch.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        launch.restype = ctypes.c_int
        words.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_int]
        words.restype = ctypes.c_longlong
        chunk_words.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        chunk_words.restype = ctypes.c_longlong
        _fns = launch, words, chunk_words
    return _fns


def segment_combine_cuda(vals: torch.Tensor, seg_ids: torch.Tensor,
                         num_segments: int, combiner) -> torch.Tensor:
    """``(*B, N, *F)`` segment combine of CUDA ``vals`` (``(*B, E, *F)``)
    by ``seg_ids`` (``(*B, E)``); ids outside ``[0, N)`` are dropped.
    Each row's ids must be sorted ascending (unsorted ids give a wrong
    result but no out-of-bounds access). float32/int32 for sum/min/max/
    prod and ``min_by_first`` (values ``(*B, E, D)``, the key in column
    0; empty segments hold ``identity_like``); bool ``or`` runs as max
    over 0/1 int32. Any number of rows (the product of ``*B``): past
    65,535, the launch grid's rows, each block loops over rows. A row
    holds up to 2,048 x (2^31 - 1) entries (its tiles of 2,048 on the
    grid's x dimension; 2^32 - 2 for ``min_by_first``)."""
    global launches
    if not (vals.is_cuda and seg_ids.is_cuda):
        raise ValueError("segment_combine_cuda needs CUDA tensors")
    name = combiner.name
    is_or = name == "or" and vals.dtype == torch.bool
    work = vals.to(torch.int32) if is_or else vals
    op = _OPS.get("max" if is_or else name)
    if op is None or work.dtype not in _DTYPES:
        raise TypeError(
            f"segment_combine kernel has no {name!r} for {vals.dtype} "
            f"(float32/int32 sum/min/max/prod/min_by_first, bool or)")
    if name == "min_by_first" and vals.dim() != seg_ids.dim() + 1:
        raise ValueError(
            "min_by_first reduces (*B, E, D) rows by (*B, E) ids; got "
            f"values {tuple(vals.shape)} and ids {tuple(seg_ids.shape)}")
    batch, e = tuple(seg_ids.shape[:-1]), seg_ids.shape[-1]
    feat = tuple(vals.shape[seg_ids.dim():])
    rows, n, d = math.prod(batch), num_segments, math.prod(feat)
    v = work.reshape(rows, e, d).contiguous()
    seg = seg_ids.reshape(rows, e).to(torch.int32).contiguous()
    out = torch.empty((rows, n, d), dtype=work.dtype, device=vals.device)
    if rows and n and d:
        launch, words, chunk_words = _library()
        # the per-tile partials: this call's alone, made anew
        tiles = torch.empty(words(rows, e, d, op), dtype=torch.int32,
                            device=vals.device)
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        table = chunks_of(vals.device).take(chunk_words(rows, n, d))
        err = launch(v.data_ptr(), seg.data_ptr(), out.data_ptr(),
                     tiles.data_ptr(), table.data_ptr(), rows, e, n, d,
                     _DTYPES[work.dtype], op, stream)
        if err:
            raise RuntimeError(f"segment_combine kernel launch failed: CUDA "
                               f"error {err}")
        launches += 1
    if is_or:  # max over 0/1; an empty segment's INT_MIN is False too
        out = out > 0
    return out.reshape(batch + (n,) + feat)
