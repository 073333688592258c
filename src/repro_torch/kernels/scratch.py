"""Where the kernels' persistent scratch lives.

``bucket_ranks`` keeps status words and a control word, and
``segment_combine`` a chunk table, from one launch to the next; each
launch leaves them ready for the next one, with no memset. Launches that
share one scratch must run one after another. By default a scratch
belongs to a (device, stream): launches on one stream run in order.

A superstep loop captured into a CUDA graph launches on the streams it
captures on (its conditional bodies on a stream of their own), and its
replays run on the caller's stream. So the
runtime names the scratch itself: under :func:`scope` every launch on a
device uses the scratch of that scope, whatever the stream. The scope is
entered for the warm-up step, which sizes the scratch, and for the
capture, whose launches then keep those buffers' addresses. A scratch
that would have to grow while a stream captures raises
(:func:`check_growth`): the new buffer, and its zero fill, would be made
inside the graph and replayed with it.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Hashable, List, Optional

import torch

_scope: Optional[Hashable] = None
_tables: List[Dict[Any, Any]] = []


def table() -> Dict[Any, Any]:
    """A new per-key scratch table, which :func:`release` also empties."""
    t: Dict[Any, Any] = {}
    _tables.append(t)
    return t


def key(device: torch.device) -> tuple:
    """The scratch key of a launch on ``device`` now: the open scope's,
    else the current stream's."""
    index = (torch.cuda.current_device() if device.index is None
             and device.type == "cuda" else device.index)
    if _scope is not None:
        return (index, "scope", _scope)
    return (index, torch.cuda.current_stream(device).cuda_stream)


@contextlib.contextmanager
def scope(token: Hashable):
    """Every launch under the scope uses the scratch named ``token``."""
    global _scope
    prev, _scope = _scope, token
    try:
        yield
    finally:
        _scope = prev


def release(token: Hashable) -> None:
    """Drop every scratch of the scope ``token``."""
    for t in _tables:
        for k in [k for k in t if len(k) == 3 and k[2] == token]:
            del t[k]


def check_growth(device: torch.device, what: str) -> None:
    """Raise when a scratch on ``device`` would be (re)made while the
    stream captures."""
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"{what}: its scratch would grow while a CUDA graph captures; "
            "the warm-up step before the capture must size it")
