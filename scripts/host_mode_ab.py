#!/usr/bin/env python3
"""The port's host mode against another checkout's, on the card.

    python3 scripts/host_mode_ab.py --other DIR [--keys K1,K2,...]
        [--scale 20] [--reps 7] [--rounds 1] [--out FILE]

Times ``Engine.run`` in host mode (init and extract included) and the
superstep loop alone (``RunResult.wall_time_s``), min and median of
``--reps`` runs after one warm-up, for each program of ``--keys`` on the
registry's graph at ``--scale``, W=8 (``pagerank`` runs 30 supersteps).
Each checkout runs in a process of its own, in the order other, this,
this, other (``--rounds`` times), so a drift of the card or its host
shows as a gap between the processes of one checkout. ``DIR`` is the
root of a checkout (for a parent commit, ``git archive`` into the
git-ignored ``build/``); its kernels build into its own ``build/``. All
processes of a checkout must give the same supersteps and bytes. Prints one JSON object with the
card's name and power limit and writes it to ``--out`` (default
``chiprun_out/host_mode_ab.json``). Needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
W = 8


def child(root: Path, keys, scale: int, reps: int) -> dict:
    """Host-mode times of ``keys`` with the port under ``root``."""
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.algorithms import REGISTRY
    from repro_torch.graph import pgraph
    from repro_torch.kernels import build
    from repro_torch.pregel.engine import Engine

    build.build_all()
    out = {}
    for key in keys:
        spec = REGISTRY[key]
        graph = spec.make_graph(scale, 0)
        pg = pgraph.partition_graph(graph, W, "random", build=spec.build)
        knobs = {"iters": 30} if key.startswith("pagerank") else {}
        prog = spec.factory(**spec.inputs(graph, 0), **knobs)
        eng = Engine(mode="host")
        eng.run(prog, pg)
        runs, loops = [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = eng.run(prog, pg)
            torch.cuda.synchronize()
            runs.append(1e3 * (time.perf_counter() - t))
            loops.append(1e3 * res.wall_time_s)
        runs.sort()
        loops.sort()
        out[key] = dict(steps=res.steps, bytes=res.total_bytes,
                        run_ms=runs, loop_ms=loops,
                        run_min_ms=runs[0], run_median_ms=runs[reps // 2],
                        loop_min_ms=loops[0],
                        loop_median_ms=loops[reps // 2])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of the checkout to compare with")
    ap.add_argument("--keys",
                    default="pagerank:scatter,wcc:basic,sv:basic")
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "host_mode_ab.json"))
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    keys = args.keys.split(",")
    if args.child:
        print(json.dumps(child(Path(args.child), keys, args.scale,
                               args.reps)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("host_mode_ab: CUDA is not available", file=sys.stderr)
        return 2
    if not args.other or not (Path(args.other) / "src" /
                              "repro_torch").is_dir():
        print("host_mode_ab: --other must be a checkout root with "
              "src/repro_torch", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    roots = {"other": Path(args.other).resolve(), "this": ROOT}
    runs = []
    for label in ("other", "this", "this", "other") * args.rounds:
        proc = subprocess.run(
            [sys.executable, __file__, "--child", str(roots[label]),
             "--keys", args.keys, "--scale", str(args.scale),
             "--reps", str(args.reps)],
            capture_output=True, text=True, timeout=900)
        if proc.returncode:
            sys.stderr.write(proc.stderr)
            raise SystemExit(f"host_mode_ab: the {label} process failed")
        runs.append((label, json.loads(proc.stdout.strip().splitlines()[-1])))
    summary = {}
    for key in keys:
        by = {label: [r[key] for lab, r in runs if lab == label]
              for label in roots}
        for label, rs in by.items():
            if len({(r["steps"], r["bytes"]) for r in rs}) != 1:
                raise SystemExit(f"host_mode_ab: {key} {label}: its "
                                 "processes disagree on steps or bytes")
        summary[key] = {label: dict(
            steps=rs[0]["steps"], bytes=rs[0]["bytes"],
            run_min_ms=min(r["run_min_ms"] for r in rs),
            run_median_ms=[r["run_median_ms"] for r in rs],
            loop_min_ms=min(r["loop_min_ms"] for r in rs),
            loop_median_ms=[r["loop_median_ms"] for r in rs])
            for label, rs in by.items()}
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "scale": args.scale, "workers": W, "reps": args.reps,
           "order": [lab for lab, _ in runs], "other": str(args.other),
           "summary": summary, "runs": runs}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(dict(out, runs=None)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
