"""Host-side checkpoints of chunked runs — the port of
``repro.pregel.checkpoint``.

``Engine.run(prog, pg, checkpoint_every=K, checkpoint_dir=...)`` snapshots
the chunked loop's carry at the first chunk (dispatch) boundary at or past
every K supersteps: the step counter, the state (host numpy) and the
traffic so far. ``Engine.run(..., resume=path_or_checkpoint)`` (``python
-m repro_torch run <prog> --resume <path>``) writes that carry back into
the loop's buffers — the step into the counter the captured steps read,
the state into the state buffers, the traffic into the host's int64
accumulators — and replays the captured graph from there, so the resumed
run equals the uninterrupted one bit for bit: state, supersteps, halts,
and bytes and messages per channel.

On a group (``Engine(backend="dist")``) rank 0 writes the file from the
state gathered from every rank, the file a local run writes at the same
boundary byte for byte, and each rank resumes its own worker's rows, so
a checkpoint resumes on either backend.

A checkpoint names the program, the hash of the graph's static surface
(``runtime.graph_signature``: the whole partition's, on a rank too) and
``max_steps``;
:meth:`Checkpoint.validate` refuses a resume with another program, graph
shape or step budget. A file is a pickled dict of plain values and numpy
arrays with a format tag (the port's own format, not the JAX package's),
written atomically: into a temporary file, then renamed.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import tempfile
from typing import Any, Dict, Optional

from repro_torch.pregel.runtime import graph_signature

FORMAT = "repro_torch.checkpoint/1"


def graph_hash(pg) -> str:
    """Short stable hash of a graph's static surface — what a resumed run
    must share with the run that wrote the checkpoint."""
    return hashlib.sha1(repr(graph_signature(pg)).encode()).hexdigest()[:16]


@dataclasses.dataclass
class Checkpoint:
    """One chunk-boundary snapshot of a chunked run."""

    program: str
    graph: str                    # graph_hash(pg) at save time
    max_steps: int
    step: int                     # supersteps done at this boundary
    state: Dict[str, Any]         # state leaves as host numpy
    bytes_by_channel: Dict[str, int]
    msgs_by_channel: Dict[str, int]
    overflow_by_channel: Dict[str, bool]
    dispatches: int

    def carry(self) -> dict:
        """The resume carry ``runtime.DeviceLoop.execute`` takes."""
        return {
            "step": self.step,
            "state": self.state,
            "bytes_by_channel": dict(self.bytes_by_channel),
            "msgs_by_channel": dict(self.msgs_by_channel),
            "overflow_by_channel": dict(self.overflow_by_channel),
        }

    def validate(self, program: str, pg, max_steps: int) -> None:
        if program != self.program:
            raise ValueError(
                f"checkpoint was written by program {self.program!r}, "
                f"cannot resume {program!r} from it")
        gh = graph_hash(pg)
        if gh != self.graph:
            raise ValueError(
                f"checkpoint graph signature {self.graph} does not match "
                f"this graph ({gh}) — resume needs the same partitioned "
                "graph shape (same scale/workers/partitioner/caps)")
        if max_steps != self.max_steps:
            raise ValueError(
                f"checkpoint was taken under max_steps={self.max_steps}, "
                f"resuming with max_steps={max_steps} would not replay the "
                "uninterrupted run — pass the same step budget")


def save(ckpt: Checkpoint, directory: str) -> str:
    """Write ``step_<n>.ckpt`` atomically into ``directory``; returns its
    path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{ckpt.step:08d}.ckpt")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            pickle.dump(dict(vars(ckpt), format=FORMAT), fh,
                        protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def load(path: str) -> Checkpoint:
    with open(path, "rb") as fh:
        data = pickle.load(fh)
    if not (isinstance(data, dict) and data.pop("format", None) == FORMAT):
        raise ValueError(f"{path} is not a {FORMAT} checkpoint file")
    return Checkpoint(**data)


def latest(directory: str) -> Optional[str]:
    """Path of the highest-step checkpoint in ``directory`` (None when it
    holds none)."""
    if not os.path.isdir(directory):
        return None
    files = sorted(f for f in os.listdir(directory) if f.endswith(".ckpt"))
    return os.path.join(directory, files[-1]) if files else None
