"""IF conditional nodes in a captured CUDA graph (``csrc/graph_if.cu``):
what the fused and chunked modes put each captured superstep under.

While a stream captures a graph, :func:`if_node` opens an IF node whose
condition is a device bool read when the graph runs, and makes a second
stream capture the node's body: the work issued inside the ``with`` runs
only when the bool was true. The body stream's allocations go to a
memory pool of its own (:func:`body_allocations`), which lives as long as
the graph that uses it (:func:`release_pool`): PyTorch's allocator routes
a capturing stream's allocations to the graph's pool only for the stream
that began the capture. Nothing here runs at import time.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from repro_torch.kernels import build

_fns = None


def _library():
    global _fns
    if _fns is None:
        lib = build.library("graph_if")
        begin, end = lib.graph_if_begin, lib.graph_if_end
        begin.argtypes = [ctypes.c_void_p] * 3
        end.argtypes = [ctypes.c_void_p]
        begin.restype = end.restype = ctypes.c_int
        _fns = begin, end
    return _fns


@contextlib.contextmanager
def body_allocations(body: torch.cuda.Stream, pool):
    """Every allocation made on ``body`` inside the ``with`` comes from
    ``pool`` (``torch.cuda.graph_pool_handle()``)."""
    dev = body.device.index
    with torch.cuda.stream(body):
        torch._C._cuda_beginAllocateCurrentStreamToPool(dev, pool)
    try:
        yield
    finally:
        torch._C._cuda_endAllocateToPool(dev, pool)


def release_pool(device: torch.device, pool) -> None:
    """Give ``pool`` back once no graph replays its memory."""
    torch._C._cuda_releasePool(device.index, pool)


@contextlib.contextmanager
def if_node(pred: torch.Tensor, capturing: torch.cuda.Stream,
            body: torch.cuda.Stream):
    """Inside the ``with``, the current stream is ``body`` and its work is
    the body of an IF node of the graph ``capturing`` captures: it runs
    only when the 0-d bool ``pred`` holds True as the graph reaches it."""
    if pred.dtype != torch.bool or pred.numel() != 1 or not pred.is_cuda:
        raise ValueError("an IF node's condition is a one-element CUDA bool")
    begin, end = _library()
    err = begin(capturing.cuda_stream, pred.data_ptr(), body.cuda_stream)
    if err:
        raise RuntimeError(f"opening an IF node failed: CUDA error {err}")
    finished = False
    try:
        with torch.cuda.stream(body):
            yield
        finished = True
    finally:
        err = end(body.cuda_stream)
        if err and finished:  # else the body's own error is the one to see
            raise RuntimeError(f"closing an IF node failed: CUDA error {err}")
