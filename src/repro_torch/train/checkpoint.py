"""Fault-tolerant checkpointing, the port of ``repro.train.checkpoint``,
in the JAX package's on-disk layout:

- Atomic: writes ``<dir>/tmp.<step>.<proc>``, then renames it to
  ``<dir>/step_<n>`` (8 digits).
- Per process: ``shard_<proc>.npz`` holds the arrays under their leaf
  paths (``params/blocks/l0/wq``, ``opt/step``, ``opt/m/...``; dict keys
  in sorted order, as JAX flattens them) beside ``manifest.json`` (step,
  and each leaf's path, shape and dtype).
- Async: a writer thread serializes while training continues.

A checkpoint written by either package restores in the other. A
bfloat16 leaf is stored as its 2-byte words, as numpy writes a JAX
bfloat16 array (dtype ``V2``), under the manifest's ``"bfloat16"``, and
read back bit for bit; no ``ml_dtypes`` is needed. (The JAX ``restore``
cannot cast such a leaf, its own included: ROADMAP fault 12.) Restoring
onto a sharding waits for ROADMAP item 9.3.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs of a tree of NamedTuples and dicts in JAX's
    order: NamedTuple fields in order, dict keys sorted."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    else:
        return [(prefix, tree)]
    return [pv for k, v in items
            for pv in _flatten(v, f"{prefix}/{k}" if prefix else str(k))]


def _rebuild(tree, leaves, prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``leaves[path]``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_rebuild(v, leaves,
                                     f"{prefix}/{k}" if prefix else k)
                            for k, v in zip(tree._fields, tree)])
    return leaves[prefix]


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a numpy array and its manifest dtype."""
    if isinstance(leaf, torch.Tensor):
        # a copy also on the CPU: training goes on writing the leaf in
        # place while an async writer reads this one
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), \
                "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored array as a tensor; a ``"bfloat16"`` leaf from its bits."""
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def save(ckpt_dir: str, step: int, tree: Any, process_index: int = 0,
         blocking: bool = True) -> Optional[threading.Thread]:
    """Save a tree (a ``TrainState`` or nested dicts of tensors). The
    device-to-host copy happens here; with ``blocking=False`` a writer
    thread does the rest and is returned."""
    host = [(path, *_to_host(v)) for path, v in _flatten(tree)]

    def write():
        tmp = os.path.join(ckpt_dir, f"tmp.{step}.{process_index}")
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, f"shard_{process_index}.npz"),
                 **{k: a for k, a, _ in host})
        manifest = {
            "step": step,
            "leaves": [{"path": k, "shape": list(a.shape), "dtype": dt}
                       for k, a, dt in host],
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)

    if blocking:
        write()
        return None
    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


@torch.no_grad()
def restore(ckpt_dir: str, target: Any, step: Optional[int] = None,
            shardings: Any = None, process_index: int = 0,
            device=None) -> Any:
    """Restore into the structure of ``target`` (default step: the
    latest), each leaf cast to the target leaf's dtype. A target leaf
    that holds memory is written in place and returned (at full width the
    state is not held twice); a ``meta`` target leaf becomes a new tensor
    on ``device``."""
    if shardings is not None:
        raise NotImplementedError(
            "restore onto a sharding waits for the port's sharded LM "
            "(ROADMAP item 9.3); restore unsharded")
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        dtypes = {leaf["path"]: leaf["dtype"]
                  for leaf in json.load(f)["leaves"]}
    out = {}
    with np.load(os.path.join(d, f"shard_{process_index}.npz")) as data:
        for path, tgt in _flatten(target):
            src = _from_host(data[path], dtypes[path])
            assert tuple(src.shape) == tuple(tgt.shape), (
                path, tuple(src.shape), tuple(tgt.shape))
            if tgt.device.type == "meta":
                out[path] = src.to(device=device, dtype=tgt.dtype)
            else:
                out[path] = tgt.copy_(src.to(tgt.dtype))
    return _rebuild(target, out)
