"""Training driver, the port of ``repro.launch.train``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --steps 200 --seq-len 256 --global-batch 8 --smoke \\
        --ckpt-dir build/ckpt [--device cpu]

One process on one device (default: the CUDA device; it raises without
one unless ``--device cpu`` is given). With ``--ckpt-dir`` a checkpoint
there is resumed (the pipeline's batches are pure functions of the step)
and new ones are written every ``--save-every`` steps and at the end;
SIGTERM writes a final checkpoint. ``main(argv)`` takes the arguments as
a list.

``--mesh DxM`` (or ``PxDxM``) trains on D·M ranks: each rank draws and
holds its shards of the state (``distributed.sharding.train_state_pspecs``,
FSDP over the data axes, TP/EP over "model"), its rows of every batch,
and steps under ``distributed.context.activation_sharding``; rank 0
prints the lines above. The ranks are this process's ``torch.distributed``
group when one is set (``RANK``/``WORLD_SIZE`` in the environment, as
``torchrun`` sets them), else ``launch.workers.spawn`` starts them: gloo
on the CPU or for ranks that share a card, NCCL with one card a rank.
``--seq-parallel`` shards the residual stream's sequence over "model".
Checkpoints hold the whole state in the unsharded layout, so a run
resumes on any mesh.
"""
from __future__ import annotations

import argparse
import contextlib
import math
import os
import signal
import sys
import time
from typing import List, Optional

import torch


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run(args, cfg, dev, pipe, step_fn, init_fn, sup, shardings=None,
         place=lambda batch: batch, ctx=contextlib.nullcontext,
         print=print) -> list:
    """The training loop of :func:`main`: restore or init, step, log,
    save. ``ctx()`` is entered around each step. Returns the losses."""
    from repro_torch.distributed.fault_tolerance import StragglerMonitor
    from repro_torch.models.params import tree_leaves

    start = 0
    if sup:
        state, start = sup.restore_or(init_fn) if shardings is None else \
            sup.restore_or(init_fn, shardings=shardings)
        if start:
            print(f"[train] resumed from step {start}")
    else:
        state = init_fn()

    mon = StragglerMonitor(
        on_straggler=lambda s, t, m: print(
            f"[straggler] step {s}: {t:.3f}s vs median {m:.3f}s"))
    nparams = sum(x.numel() for x in tree_leaves(state.params))
    print(f"[train] {cfg.name}: {nparams/1e6:.1f}M params on {dev}, "
          f"{args.global_batch}x{args.seq_len} tokens/step, "
          f"steps {start}..{args.steps}")

    losses = []
    step = start - 1
    for step in range(start, args.steps):
        t0 = time.perf_counter()
        with ctx():
            state, metrics = step_fn(state, place(pipe.batch_at(step)))
        loss = float(metrics["loss"])
        _sync(dev)
        losses.append(loss)
        dt = time.perf_counter() - t0
        mon.record(step, dt)
        if step % args.log_every == 0:
            tok_s = args.global_batch * args.seq_len / dt
            print(f"  step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"{dt*1e3:7.1f} ms/step {tok_s:10.0f} tok/s")
        if sup:
            sup.maybe_save(step, state)
            if sup.preempted:
                print("[train] preempted — final checkpoint written")
                break
    if sup and step >= start:
        sup.finalize(min(step, args.steps - 1), state)
    if losses:
        print(f"[train] done. loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"(median step {mon.median*1e3:.1f} ms, "
              f"straggler flags {mon.flags})")
    else:
        print(f"[train] done. nothing to run: steps {start}..{args.steps}")
    return losses


def _sharded(rank: int, world: int, dev, argv: List[str],
             backend: str) -> list:
    """One rank of ``--mesh``: its shards of the state, its rows of each
    batch, the step under ``activation_sharding``. Rank 0 prints."""
    from repro_torch.configs import registry
    from repro_torch.distributed import context, host_staging
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.fault_tolerance import TrainSupervisor
    from repro_torch.distributed.moe_spmd import make_spmd_moe
    from repro_torch.launch.mesh import Mesh, mesh_arg
    from repro_torch.train import data as data_lib
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import AdamW

    args = _parser().parse_args(argv)
    if args.seq_parallel:
        context.DEFAULT_SEQ_PARALLEL = True
    if dev.type == "cuda" and backend == "gloo":
        host_staging.install()
    sizes, axes = mesh_arg(args.mesh)
    mesh = Mesh(sizes, axes, dev.type)
    spec = registry.ARCHS[args.arch]
    cfg = spec.smoke if args.smoke else spec.config
    opt = AdamW(lr=args.lr)
    pipe = data_lib.SyntheticLM(cfg, args.seq_len, args.global_batch,
                                seed=args.seed, device=dev)
    moe_impl = make_spmd_moe(cfg, mesh) if cfg.moe_experts else None
    step_fn = ts.make_train_step(cfg, opt, microbatches=args.microbatches,
                                 remat=True, moe_impl=moe_impl)
    shardings = sh.named(mesh, sh.train_state_pspecs(cfg, mesh))

    def init_fn():
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        return ts.init_train_state(cfg, opt, gen, device=dev, mesh=mesh)

    def place(batch):
        return sh.distribute(batch, mesh, sh.batch_pspecs(
            cfg, mesh, batch, args.global_batch))

    sup = None
    if args.ckpt_dir:
        sup = TrainSupervisor(args.ckpt_dir, save_every=args.save_every)
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"[train] mesh {mesh.shape} on {world} ranks ({backend}, "
        f"{dev.type})")
    return _run(args, cfg, dev, pipe, step_fn, init_fn, sup,
                shardings=shardings, place=place,
                ctx=lambda: context.activation_sharding(mesh), print=say)


def _from_env(argv: List[str], dev) -> list:
    """``--mesh`` on the group the environment names (``torchrun``)."""
    import torch.distributed as dist

    backend = "nccl" if dev.type == "cuda" and torch.cuda.device_count() \
        >= int(os.environ["WORLD_SIZE"]) else "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend)
    rank = dist.get_rank()
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return _sharded(rank, dist.get_world_size(), dev, argv, backend)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default=None,
                    help="e.g. '2x2' or '2x16x16' (data x model, pod x data "
                         "x model; default: one device, unsharded)")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="with --mesh: shard the residual stream's sequence "
                         "over the model axis")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    ap = _parser()
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)
    if args.mesh:
        from repro_torch.device import resolve_device
        from repro_torch.launch import workers
        from repro_torch.launch.mesh import mesh_arg

        try:
            world = math.prod(mesh_arg(args.mesh)[0])
        except ValueError as err:
            ap.error(f"--mesh: {err}")
        dev = resolve_device(args.device)
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            _from_env(argv, dev)
            return 0
        cuda = dev.type == "cuda"
        backend = "nccl" if cuda and torch.cuda.device_count() >= world \
            else "gloo"
        workers.spawn(_sharded, world, argv, backend,
                      device="cuda" if cuda else "cpu", backend=backend,
                      timeout_s=600)
        return 0

    from repro_torch.configs import registry
    from repro_torch.device import resolve_device
    from repro_torch.distributed.fault_tolerance import TrainSupervisor
    from repro_torch.train import data as data_lib
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import AdamW

    dev = resolve_device(args.device)
    spec = registry.ARCHS[args.arch]
    cfg = spec.smoke if args.smoke else spec.config
    opt = AdamW(lr=args.lr)
    pipe = data_lib.SyntheticLM(cfg, args.seq_len, args.global_batch,
                                seed=args.seed, device=dev)
    step_fn = ts.make_train_step(cfg, opt, microbatches=args.microbatches,
                                 remat=True)

    def init_fn():
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        return ts.init_train_state(cfg, opt, gen, device=dev)

    sup = None
    prev_handler = None
    if args.ckpt_dir:
        sup = TrainSupervisor(args.ckpt_dir, save_every=args.save_every)
        prev_handler = sup.install_preemption_handler()
    try:
        _run(args, cfg, dev, pipe, step_fn, init_fn, sup)
    finally:
        if sup:  # the supervisor's handler ends with its loop
            signal.signal(signal.SIGTERM, prev_handler if prev_handler
                          is not None else signal.SIG_DFL)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
