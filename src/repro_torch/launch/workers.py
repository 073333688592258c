"""Start W worker processes over one ``torch.distributed`` group — the
port's counterpart of ``repro.launch.mesh``, for
``Engine(backend="dist")``.

:func:`spawn` starts ``world`` ranks with the ``spawn`` start method, a
``FileStore`` rendezvous in a temporary directory (no TCP port, so tests
running side by side never fight over one), the group's timeout set from
``timeout_s`` and each rank's device set: ``cuda:{rank % device_count}``
on the card, the CPU when asked. It calls ``fn(rank, world, device,
*args)`` on every rank and returns the ranks' return values in rank
order.

Transport: NCCL refuses two ranks on one card, so ranks that share a
card (W ranks on one H100) talk over **gloo**, which stages CUDA tensors
through host memory itself; with one card a rank ``backend="nccl"``
runs the group over NCCL. The CPU ranks of the tests are gloo.

A rank that raises ends the spawn: the others are killed and
:func:`spawn` raises with the rank's traceback. A rank that misses a
collective leaves the others waiting in it until the group's timeout,
when they raise; ``join_timeout_s`` bounds the whole spawn besides.

Ranks re-import ``fn`` by its module path (the ``spawn`` start method),
so ``fn`` lives in an importable module, not in a closure or a
``python -c`` string.
"""
from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.multiprocessing as mp

TRANSPORTS = ("gloo", "nccl")


def rank_device(rank: int, device: str) -> torch.device:
    """A rank's device: the CPU, or card ``rank % device_count``."""
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to spawn CPU ranks")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(rank: int, fn: Callable, world: int, workdir: str,
               device: str, backend: str, timeout_s: float,
               threads: Optional[int], args: tuple) -> None:
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, world, dev, *args)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        # the time comes first, so the spawn names the rank that failed
        # first, not one that failed because a peer had gone
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(f"{time.time()!r}\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


def _first_failure(workdir: str) -> Optional[str]:
    """The traceback of the rank that failed first, by the time its
    failure was written."""
    errs = []
    for name in os.listdir(workdir):
        if name.endswith(".err"):
            with open(os.path.join(workdir, name)) as f:
                when, _, tb = f.read().partition("\n")
            errs.append((float(when), name[len("rank"):-len(".err")], tb))
    if not errs:
        return None
    _, rank, tb = min(errs)
    return f"rank {rank} failed first:\n{tb}"


def _joined(ctx, workdir: str) -> bool:
    """``ctx.join`` for half a second; a rank's failure raises with the
    first failing rank's traceback."""
    try:
        return ctx.join(timeout=0.5)
    except Exception as err:  # a rank raised or died
        first = _first_failure(workdir)
        if first is None:
            raise
        raise RuntimeError(first) from err


def spawn(fn: Callable, world: int, *args, device: str = "cuda",
          backend: str = "gloo", timeout_s: float = 60.0,
          join_timeout_s: Optional[float] = None,
          threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(rank, world, device, *args)`` on ``world`` ranks of one
    group; return the ranks' return values in rank order.

    device: ``"cuda"`` (card ``rank % device_count`` a rank) or ``"cpu"``.
    backend: ``"gloo"`` (any ranks, CUDA tensors staged through the host
      by gloo) or ``"nccl"`` (one card a rank).
    timeout_s: the group's timeout — a rank left waiting in a collective
      raises after it.
    join_timeout_s: the whole spawn's bound (default ``4 * timeout_s``);
      past it every rank is killed and ``TimeoutError`` raised.
    threads: ``torch.set_num_threads`` of each rank (None: torch's).

    The rendezvous file and the ranks' results go to a temporary
    directory, removed afterwards.
    """
    if backend not in TRANSPORTS:
        raise ValueError(f"unknown transport {backend!r} (one of "
                         f"{TRANSPORTS})")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device is 'cuda' or 'cpu', not {device!r}")
    if backend == "nccl":
        if device != "cuda":
            raise ValueError("NCCL runs on cards, not the CPU")
        if torch.cuda.device_count() < world:
            raise ValueError(
                f"NCCL takes one card a rank: {world} ranks, "
                f"{torch.cuda.device_count()} card(s)")
    if device == "cuda":
        # build the kernels once here, so W ranks do not race to compile
        from repro_torch.kernels import build

        build.build_all()
    work = tempfile.mkdtemp(prefix="repro_torch_spawn_")
    bound = 4 * timeout_s if join_timeout_s is None else join_timeout_s
    deadline = time.monotonic() + bound
    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, work, device, backend, timeout_s,
                              threads, args),
            nprocs=world, join=False, start_method="spawn")
        while not _joined(ctx, work):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(
                    f"spawn of {world} ranks ran past its {bound:g} s "
                    "bound")
        out = []
        for rank in range(world):
            with open(os.path.join(work, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)
