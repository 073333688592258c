"""Training driver, the port of ``repro.launch.train``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --steps 200 --seq-len 256 --global-batch 8 --smoke \\
        --ckpt-dir build/ckpt [--device cpu]

One process on one device (default: the CUDA device; it raises without
one unless ``--device cpu`` is given). With ``--ckpt-dir`` a checkpoint
there is resumed (the pipeline's batches are pure functions of the step)
and new ones are written every ``--save-every`` steps and at the end;
SIGTERM writes a final checkpoint. ``--mesh`` (sharded training) waits
for ROADMAP item 9.3. ``main(argv)`` takes the arguments as a list.
"""
from __future__ import annotations

import argparse
import signal
import time
from typing import List, Optional

import torch


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run(args, cfg, dev, pipe, step_fn, init_fn, sup) -> None:
    """The training loop of :func:`main`: restore or init, step, log,
    save."""
    from repro_torch.distributed.fault_tolerance import StragglerMonitor
    from repro_torch.models.params import tree_leaves

    start = 0
    if sup:
        state, start = sup.restore_or(init_fn)
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
        state, metrics = step_fn(state, pipe.batch_at(step))
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


def main(argv: Optional[List[str]] = None) -> int:
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
                    help="refused: sharded training is ROADMAP item 9.3")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    if args.mesh:
        ap.error("--mesh: sharded training waits for the port's sharded LM "
                 "(ROADMAP item 9.3); run without it on one device")

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
