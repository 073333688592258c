"""IF and WHILE conditional nodes in a captured CUDA graph
(``csrc/graph_if.cu``): what the fused and chunked modes put each
captured superstep, and each inner loop of a superstep, under.

While a stream captures a graph, :func:`if_node` opens an IF node whose
condition is a device bool read when the graph runs, and makes a second
stream capture the node's body: the work issued inside the ``with`` runs
only when the bool was true. :func:`while_node` opens a WHILE node the
same way: its body runs while the bool holds true, read as the graph
reaches the node and again at the end of each run of the body, which
updates it. Nodes nest: the stream that captures a body may open another
node, to any depth; :class:`Nest` gives each depth its body stream.

A body stream's allocations go to a memory pool of its own
(:func:`body_allocations`), which lives as long as the graph that uses it
(:func:`release_pool`): PyTorch's allocator routes a capturing stream's
allocations to the graph's pool only for the stream that began the
capture. Nothing here runs at import time.
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
        fns = (lib.graph_if_begin, lib.graph_if_end, lib.graph_while_begin,
               lib.graph_while_end)
        fns[0].argtypes = [ctypes.c_void_p] * 3
        fns[1].argtypes = [ctypes.c_void_p]
        fns[2].argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.POINTER(ctypes.c_ulonglong)]
        fns[3].argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_ulonglong]
        for fn in fns:
            fn.restype = ctypes.c_int
        _fns = fns
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


def _check_pred(pred: torch.Tensor, what: str) -> None:
    if pred.dtype != torch.bool or pred.numel() != 1 or not pred.is_cuda:
        raise ValueError(f"{what}'s condition is a one-element CUDA bool")


@contextlib.contextmanager
def _body(what: str, end, body: torch.cuda.Stream):
    """The ``with`` of a node whose body capture has begun on ``body``;
    ``end()`` ends it."""
    finished = False
    try:
        with torch.cuda.stream(body):
            yield
        finished = True
    finally:
        err = end()
        if err and finished:  # else the body's own error is the one to see
            raise RuntimeError(f"closing {what} failed: CUDA error {err}")


@contextlib.contextmanager
def if_node(pred: torch.Tensor, capturing: torch.cuda.Stream,
            body: torch.cuda.Stream):
    """Inside the ``with``, the current stream is ``body`` and its work is
    the body of an IF node of the graph ``capturing`` captures: it runs
    only when the 0-d bool ``pred`` holds True as the graph reaches it."""
    _check_pred(pred, "an IF node")
    begin, end = _library()[:2]
    err = begin(capturing.cuda_stream, pred.data_ptr(), body.cuda_stream)
    if err:
        raise RuntimeError(f"opening an IF node failed: CUDA error {err}")
    with _body("an IF node", lambda: end(body.cuda_stream), body):
        yield


@contextlib.contextmanager
def while_node(pred: torch.Tensor, capturing: torch.cuda.Stream,
               body: torch.cuda.Stream):
    """Inside the ``with``, the current stream is ``body`` and its work is
    the body of a WHILE node of the graph ``capturing`` captures: it runs
    while the 0-d bool ``pred`` holds True, read as the graph reaches the
    node and again after each run of the body. The body updates
    ``pred``; a False on entry runs it no time."""
    _check_pred(pred, "a WHILE node")
    begin, end = _library()[2:]
    handle = ctypes.c_ulonglong()
    err = begin(capturing.cuda_stream, pred.data_ptr(), body.cuda_stream,
                ctypes.byref(handle))
    if err:
        raise RuntimeError(f"opening a WHILE node failed: CUDA error {err}")
    with _body("a WHILE node",
               lambda: end(body.cuda_stream, pred.data_ptr(), handle.value),
               body):
        yield


class Nest:
    """The body streams of one capture's conditional nodes: one stream a
    depth, made on first use, each allocating from a memory pool of its
    own until :meth:`close`. A node opens on the current stream (the
    capture's, or the body stream of the node it lies in) and captures
    its body on the stream one depth below. :meth:`release` gives the
    pools back once the graph is dropped."""

    def __init__(self, device: torch.device):
        index = device.index
        self.device = torch.device(
            "cuda", torch.cuda.current_device() if index is None else index)
        self.streams, self.pools = [], []
        self.depth = 0
        self._routing = contextlib.ExitStack()

    def _stream(self) -> torch.cuda.Stream:
        if self.depth == len(self.streams):
            stream = torch.cuda.Stream(self.device)
            pool = torch.cuda.graph_pool_handle()
            self._routing.enter_context(body_allocations(stream, pool))
            self.streams.append(stream)
            self.pools.append(pool)
        return self.streams[self.depth]

    @contextlib.contextmanager
    def _node(self, opener, pred: torch.Tensor):
        capturing = torch.cuda.current_stream(self.device)
        body = self._stream()
        self.depth += 1
        try:
            with opener(pred, capturing, body):
                yield
        finally:
            self.depth -= 1

    def if_node(self, pred: torch.Tensor):
        """:func:`if_node` one depth below the current stream."""
        return self._node(if_node, pred)

    def while_node(self, pred: torch.Tensor):
        """:func:`while_node` one depth below the current stream."""
        return self._node(while_node, pred)

    def close(self) -> None:
        """End the pools' routing: the capture is over."""
        self._routing.close()

    def release(self) -> None:
        """Give every pool back (no graph replays their memory)."""
        self.close()
        for pool in self.pools:
            release_pool(self.device, pool)
        self.pools = []
