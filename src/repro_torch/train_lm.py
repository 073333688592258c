"""End-to-end LM training example: a ~100M-parameter mamba2-family model
(12 layers, d_model 512, a 32,000-token vocabulary, float32) trained with
microbatches 2 and checkpoints every 100 steps through the supervisor.
The port's counterpart of the JAX package's ``examples/train_lm.py``.

    PYTHONPATH=src python -m repro_torch.train_lm [--steps 300]
        [--device cpu] [--ckpt-dir DIR]

It runs on the CUDA device unless ``--device cpu`` is given (and raises
without CUDA). A checkpoint in ``--ckpt-dir`` (default
``build/train_lm`` in the repository) is resumed.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path
from typing import List, Optional

import torch

from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import (StragglerMonitor,
                                                     TrainSupervisor)
from repro_torch.models.params import tree_leaves
from repro_torch.train import data as data_lib
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import AdamW

DEFAULT_CKPT = Path(__file__).resolve().parents[2] / "build" / "train_lm"


def hundred_m_config():
    """~100M params: a scaled mamba2 (a real stack, quick per token)."""
    base = registry.ARCHS["mamba2-130m"].config
    return dataclasses.replace(
        base, name="mamba2-100m-example", n_layers=12, d_model=512,
        vocab=32000, dtype="float32")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.train_lm",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = hundred_m_config()
    opt = AdamW(lr=1e-3, warmup_steps=50)
    pipe = data_lib.SyntheticLM(cfg, args.seq_len, args.global_batch,
                                device=dev)
    step = ts.make_train_step(cfg, opt, microbatches=2, remat=True)

    sup = TrainSupervisor(args.ckpt_dir, save_every=100)
    state, start = sup.restore_or(lambda: ts.init_train_state(
        cfg, opt, torch.Generator(device=dev).manual_seed(0), device=dev))
    mon = StragglerMonitor()

    n = sum(x.numel() for x in tree_leaves(state.params))
    print(f"{cfg.name}: {n/1e6:.1f}M params on {dev} | "
          f"{args.global_batch}x{args.seq_len} tok/step | resume at {start}")

    loss = float("nan")
    for i in range(start, args.steps):
        t0 = time.perf_counter()
        state, m = step(state, pipe.batch_at(i))
        loss = float(m["loss"])
        mon.record(i, time.perf_counter() - t0)
        sup.maybe_save(i, state)
        if i % 20 == 0:
            print(f"  step {i:4d}  loss {loss:7.4f}  "
                  f"({mon.median*1e3:.0f} ms/step median)")
    if args.steps > start:
        sup.finalize(args.steps - 1, state)
    print(f"done: final loss {loss:.4f}; checkpoints in {args.ckpt_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
