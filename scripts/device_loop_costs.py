#!/usr/bin/env python3
"""What the device modes' design costs and saves on the card.

    python3 scripts/device_loop_costs.py [--scale 20] [--out FILE]

On ``pagerank:scatter`` (30 supersteps, W=8, the registry's graph at
``--scale``), min and median of five runs each, host clock around work
that ends in a synchronize:

  - ``Engine.run`` in host and fused mode (init and extract included);
  - fused with K=30 (no step skipped) against K=64 with ``max_steps=64``
    (34 steps skipped after the halt): the cost of a skipped step, an IF
    node whose condition is false;
  - the same 30 captured steps replayed as a plain graph (no IF nodes)
    against the IF-node graph (``DeviceLoop.execute``): the cost of
    running each step as a conditional body;
  - the same 30 steps run eagerly, step by step, on the loop's buffers
    (no graph): what the capture saves on the host.

Then, for ``pagerank:scatter``, ``pj:reqresp`` and ``reach:basic``, the
device time of one host-mode and one fused-mode run under torch.profiler
and the kernels that take it. Prints one JSON object (and writes it to
``--out``, default ``chiprun_out/device_loop_costs.json``) with the
card's name and power limit. Needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def timed(fn, reps: int = 5):
    """(min, median) ms of ``fn()`` over ``reps`` runs after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append(1e3 * (time.perf_counter() - t))
    runs.sort()
    return runs[0], runs[len(runs) // 2]


def device_by_kernel(fn, top: int = 8):
    """Device ms of one ``fn()`` under torch.profiler, and its top
    kernels (name, ms, launches)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in ev) / 1e3
    ev.sort(key=lambda e: -e.self_device_time_total)
    return total, [(e.key[:70], e.self_device_time_total / 1e3, e.count)
                   for e in ev[:top]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "device_loop_costs.json"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("device_loop_costs: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.algorithms import REGISTRY
    from repro_torch.graph import pgraph
    from repro_torch.kernels import build, scratch
    from repro_torch.pregel import runtime
    from repro_torch.pregel.engine import Engine

    build.build_all()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    spec = REGISTRY["pagerank:scatter"]
    pg = pgraph.partition_graph(spec.make_graph(args.scale, 0), 8, "random",
                                build=spec.build)
    prog = spec.factory(iters=30)
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "scale": args.scale, "program": "pagerank:scatter, 30 supersteps"}
    fused30, fused64 = Engine(mode="fused"), Engine(mode="fused")
    out["engine_run_host_ms"] = timed(
        lambda: Engine(mode="host").run(prog, pg))
    out["engine_run_fused_k30_ms"] = timed(lambda: fused30.run(prog, pg))
    out["engine_run_fused_k64_34_skipped_ms"] = timed(
        lambda: fused64.run(prog, pg, max_steps=64))

    loop = runtime.DeviceLoop(pg, prog.step, prog.init(pg), mode="fused",
                              max_steps=30, chunk_size=30, name="costs")
    plain = torch.cuda.CUDAGraph()
    with scratch.scope(loop.token), torch.cuda.graph(plain,
                                                     stream=loop.stream):
        for k in range(30):
            loop._step(k)

    def load():
        for name, v in prog.init(pg).items():
            loop.state[name].copy_(v)
        loop.out.zero_()
        loop.go.fill_(True)

    def plain_replay():
        load()
        plain.replay()

    def eager_steps():
        load()
        with scratch.scope(loop.token):
            for k in range(30):
                loop._step(k)

    out["loop_if_nodes_ms"] = timed(lambda: loop.execute(prog.init(pg)))
    out["loop_plain_graph_ms"] = timed(plain_replay)
    out["loop_eager_steps_ms"] = timed(eager_steps)
    del plain
    loop.release()
    fused30.clear_cache()
    fused64.clear_cache()

    profiles = {}
    for key in ("pagerank:scatter", "pj:reqresp", "reach:basic"):
        spec = REGISTRY[key]
        graph = spec.make_graph(args.scale, 0)
        pgk = pgraph.partition_graph(graph, 8, "random", build=spec.build)
        progk = spec.factory(**spec.inputs(graph, 0))
        for mode in ("host", "fused"):
            eng = Engine(mode=mode)
            wall = timed(lambda: eng.run(progk, pgk), reps=3)
            dev_ms, top = device_by_kernel(lambda: eng.run(progk, pgk))
            profiles[f"{key} {mode}"] = dict(wall_ms=wall, device_ms=dev_ms,
                                             top_kernels=top)
            eng.clear_cache()
    out["profiles"] = profiles
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
