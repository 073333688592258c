"""Serving example: batched prefill + token-by-token decode with KV cache
(greedy and sampled), on a registry architecture — by default the reduced
mixtral-family config, exercising SWA ring caches and MoE routing in the
decode path. The port's counterpart of the JAX package's
``examples/serve_lm.py``.

    PYTHONPATH=src python -m repro_torch.serve_lm [--arch NAME]
        [--size smoke|full] [--device cpu]

It runs on the CUDA device unless ``--device cpu`` is given (and raises
without CUDA). The weights are random, drawn from a seeded generator.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.models import model as M, params as Pm
from repro_torch.serve import decode as serve


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve_lm",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mixtral-8x7b",
                    choices=sorted(registry.ARCHS))
    ap.add_argument("--size", default="smoke", choices=("smoke", "full"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    spec = registry.ARCHS[args.arch]
    cfg = spec.smoke if args.size == "smoke" else spec.config
    print(f"serving {cfg.name} on {dev}: {cfg.n_layers}L d={cfg.d_model} "
          f"{cfg.moe_experts} experts top-{cfg.moe_top_k} "
          f"window={cfg.attn_window} dtype={cfg.dtype}")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = Pm.init_params(cfg, gen, dtype=M.compute_dtype(cfg), device=dev)

    batch, prompt_len, max_new = 4, 12, 16
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), device=dev,
                            generator=gen)

    _sync(dev)
    t0 = time.perf_counter()
    out = serve.generate(cfg, params, prompts, max_new=max_new)
    _sync(dev)
    t1 = time.perf_counter()
    print(f"greedy: {batch} requests x {max_new} new tokens "
          f"in {t1-t0:.2f}s ({batch*max_new/(t1-t0):.1f} tok/s)")
    print("  completions:", out[:, :8].tolist())

    out_s = serve.generate(cfg, params, prompts, max_new=max_new,
                           temperature=0.8,
                           generator=torch.Generator(device=dev).manual_seed(3))
    print("  sampled:    ", out_s[:, :8].tolist())

    # throughput sweep over batch sizes (continuous-batching capacity probe)
    for b in (1, 8, 32):
        p = torch.randint(0, cfg.vocab, (b, prompt_len), device=dev,
                          generator=gen)
        _sync(dev)
        t0 = time.perf_counter()
        serve.generate(cfg, params, p, max_new=8)
        _sync(dev)
        dt = time.perf_counter() - t0
        print(f"  batch {b:3d}: {b*8/dt:8.1f} tok/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
