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
cannot cast such a leaf, its own included: ROADMAP fault 12.)

Sharded states: ``save`` of a tree of DTensors gathers each leaf whole
(every rank takes part; rank 0 writes), so the files are the layout
above whatever the mesh; ``restore(..., shardings=)`` places every leaf
onto the target mesh (a tree of ``distributed.sharding.NamedSharding``),
each rank reading the file and keeping its own slices. A checkpoint from
one mesh restarts on another (or on none).
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


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def writes_here(tree) -> bool:
    """False on every rank but 0 of a sharded (DTensor) tree's group."""
    import torch.distributed as dist

    sharded = any(_is_dtensor(v) for _, v in _flatten(tree))
    return not sharded or dist.get_rank() == 0


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a numpy array and its manifest dtype (a DTensor gathered
    whole: a collective)."""
    if _is_dtensor(leaf):
        leaf = leaf.full_tensor()
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
    thread does the rest and is returned. A tree of DTensors is saved
    whole by rank 0; every rank must call ``save`` (the gathers are
    collectives) and the others write nothing."""
    if not writes_here(tree):
        for _, v in _flatten(tree):
            _to_host(v)  # take part in the gathers
        return None
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
    on ``device``. ``shardings`` (a tree like ``target`` of
    ``distributed.sharding.NamedSharding``) places each leaf on its mesh:
    every rank reads the file and keeps its slices (a DTensor target leaf
    is written in place; otherwise a new DTensor on ``device``)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        dtypes = {leaf["path"]: leaf["dtype"]
                  for leaf in json.load(f)["leaves"]}
    where = dict(_flatten(shardings)) if shardings is not None else {}
    out = {}
    with np.load(os.path.join(d, f"shard_{process_index}.npz")) as data:
        for path, tgt in _flatten(target):
            src = _from_host(data[path], dtypes[path])
            assert tuple(src.shape) == tuple(tgt.shape), (
                path, tuple(src.shape), tuple(tgt.shape))
            if path in where or _is_dtensor(tgt):
                out[path] = _placed(src, tgt, where.get(path, tgt), device)
            elif tgt.device.type == "meta":
                out[path] = src.to(device=device, dtype=tgt.dtype)
            else:
                out[path] = tgt.copy_(src.to(tgt.dtype))
    return _rebuild(target, out)


def _placed(src: torch.Tensor, tgt, sharding, device):
    """``src`` (the whole leaf, on the host) as a DTensor placed by
    ``sharding`` (a ``NamedSharding``, or a DTensor target's own
    placements): this rank's slice only goes to the device."""
    from repro_torch.distributed import sharding as sh

    local = src[sh.local_slices(src.shape, sharding)]
    if _is_dtensor(tgt):
        tgt.to_local().copy_(local.to(tgt.dtype))
        return tgt
    dev = device if tgt.device.type == "meta" else tgt.device
    return sh.from_local(local.to(device=dev, dtype=tgt.dtype), src.shape,
                         sharding)
