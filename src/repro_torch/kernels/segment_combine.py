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

_fn = None
#: launches of the kernel since the last reset (kernels.ops owns resets)
launches = 0


def _launcher():
    global _fn
    if _fn is None:
        fn = build.library("segment_combine").segment_combine_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def segment_combine_cuda(vals: torch.Tensor, seg_ids: torch.Tensor,
                         num_segments: int, combiner) -> torch.Tensor:
    """``(*B, N, *F)`` segment combine of CUDA ``vals`` (``(*B, E, *F)``)
    by ``seg_ids`` (``(*B, E)``); ids outside ``[0, N)`` are dropped.
    Each row's ids must be sorted ascending (the kernel clamps its offsets,
    so unsorted ids give a wrong result but no out-of-bounds read).
    float32/int32 for sum/min/max; bool ``or`` runs as max over 0/1
    int32."""
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
    v = work.reshape(rows, e, d).contiguous()
    seg = seg_ids.reshape(rows, e).to(torch.int32).contiguous()
    out = torch.empty((rows, n, d), dtype=work.dtype, device=vals.device)
    if rows and n and d:
        offsets = torch.empty((rows, n + 1), dtype=torch.int32,
                              device=vals.device)
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = _launcher()(v.data_ptr(), seg.data_ptr(), out.data_ptr(),
                          offsets.data_ptr(), rows, e, n, d,
                          _DTYPES[work.dtype], op, stream)
        if err:
            raise RuntimeError(f"segment_combine kernel launch failed: CUDA "
                               f"error {err}")
        launches += 1
    if is_or:  # max over 0/1; an empty segment's INT_MIN is False too
        out = out > 0
    return out.reshape(batch + (n,) + feat)
