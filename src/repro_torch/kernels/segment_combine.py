"""Launch wrapper of ``csrc/segment_combine.cu``: the sorted-segment
combine on the card (the scatter-combine hot loop; the port of the
Pallas ``segment_combine_pallas``)."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

_OPS = {"sum": 0, "min": 1, "max": 2}
_DTYPES = {torch.float32: 0, torch.int32: 1}
#: rows ride on the launch grid's y dimension
MAX_ROWS = 65535

_fns = None
#: launches of the kernel since the last reset (kernels.ops owns resets)
launches = 0


def _library():
    global _fns
    if _fns is None:
        lib = build.library("segment_combine")
        launch, words = (lib.segment_combine_launch,
                         lib.segment_combine_scratch_words)
        launch.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        launch.restype = ctypes.c_int
        words.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
        words.restype = ctypes.c_longlong
        _fns = launch, words
    return _fns


def segment_combine_cuda(vals: torch.Tensor, seg_ids: torch.Tensor,
                         num_segments: int, combiner) -> torch.Tensor:
    """``(*B, N, *F)`` segment combine of CUDA ``vals`` (``(*B, E, *F)``)
    by ``seg_ids`` (``(*B, E)``); ids outside ``[0, N)`` are dropped.
    Each row's ids must be sorted ascending (unsorted ids give a wrong
    result but no out-of-bounds access). float32/int32 for sum/min/max;
    bool ``or`` runs as max over 0/1 int32. At most :data:`MAX_ROWS`
    rows (the product of ``*B``)."""
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
            f"(float32/int32 sum/min/max, bool or)")
    batch, e = tuple(seg_ids.shape[:-1]), seg_ids.shape[-1]
    feat = tuple(vals.shape[seg_ids.dim():])
    rows, n, d = math.prod(batch), num_segments, math.prod(feat)
    if rows > MAX_ROWS:
        raise ValueError(f"segment_combine kernel takes at most {MAX_ROWS} "
                         f"rows, got {rows}")
    v = work.reshape(rows, e, d).contiguous()
    seg = seg_ids.reshape(rows, e).to(torch.int32).contiguous()
    out = torch.empty((rows, n, d), dtype=work.dtype, device=vals.device)
    if rows and n and d:
        launch, words = _library()
        scratch = torch.empty(words(rows, e, d), dtype=torch.int32,
                              device=vals.device)
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = launch(v.data_ptr(), seg.data_ptr(), out.data_ptr(),
                     scratch.data_ptr(), rows, e, n, d, _DTYPES[work.dtype],
                     op, stream)
        if err:
            raise RuntimeError(f"segment_combine kernel launch failed: CUDA "
                               f"error {err}")
        launches += 1
    if is_or:  # max over 0/1; an empty segment's INT_MIN is False too
        out = out > 0
    return out.reshape(batch + (n,) + feat)
