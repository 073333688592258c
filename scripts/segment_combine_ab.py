#!/usr/bin/env python3
"""Device times of ``segment_combine`` at the main paths' scale-20 shapes,
for the checkout's kernel and other versions of the same source, in one
process.

    python3 scripts/segment_combine_ab.py [--other LABEL=DIR ...] [--rounds N]
        [--rows 2,2a,...] [--walls LABEL,...]

Needs CUDA. Builds ``src/repro_torch/kernels/csrc/segment_combine.cu``
(the checkout's version, label "checkout") and, for each ``--other``, the
``segment_combine.cu`` and ``segment_combine.py`` in DIR (another version
of the kernel and its wrapper, e.g. a parent's written with ``git show
<rev>:<path>`` into ``build/``), and runs every version through its own
wrapper. The versions take turns in the order given and then reversed
(A B C C B A for two rounds). The cases are the rows of ``chip_smoke.py``
phase 5's kernel table, each send + recv at R-MAT scale 20, W = 8:

  - 2: float32 sum on the pagerank:scatter plan (random contributions
    gathered per edge; random values on the wire);
  - 2a: int32 min at the S-V plan (the vertex ids per edge; random ids on
    the wire);
  - 2b: ``min_by_first`` on msf:channels' first-superstep candidate
    combine, as captured at the order-sensitive dispatch, stable-sorted;
  - 2c: float32 sum on pagerank:basic's first-superstep CombinedMessage,
    captured and stable-sorted the same way;
  - 2e: float32 sum on pagerank:personal's Q·D = 32 columns, send and
    receive, as its first batched superstep (Q = 32) hands them over;
  - 2f: float32 min on batched sssp:prop's 32 columns at its three sites
    (``int_dst``, cut send, cut receive), the first call at each.

A version without an op (an older kernel without ``min_by_first``) skips
that case. For every version, case and round: the mean device time of
one wrapper call back to back (``cuda_ms``) and after an L2 flush
(``cuda_ms_cold``), whether the result is bit-identical to the
checkout's (and, for the exact ops, to the plain version), and from
``torch.profiler`` over 10 calls the device kernels and memsets a call
runs. Then, in the same turns, the walls of batched ``pagerank:personal``
and ``sssp:prop`` (Q = 32, ``Engine.run_batch`` in host mode and a fused
replay at K = 64) with each version's kernel launched through the
checkout's wrapper, every output bit-identical to the checkout's.
``--rows`` times only the rows named, ``--walls`` the walls of only the
versions named (``--walls none``: no walls).
Details go to ``chiprun_out/segment_combine_ab.json``; one line per
measurement is printed. Exits non-zero if any result differs.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

W, SCALE, QUERIES = 8, 20, 32


def load_other(label: str, path: Path):
    """The wrapper module in ``path`` bound to a library built from the
    ``segment_combine.cu`` beside it (its own ``build.library`` is
    replaced)."""
    from repro_torch.kernels import build

    so = ROOT / "build" / "ab" / f"segment_combine_{label}.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    out = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
         str(path / "segment_combine.cu")], capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed for {label}:\n{out.stdout}"
                           f"{out.stderr}")
    lib = ctypes.CDLL(str(so))
    spec = importlib.util.spec_from_file_location(
        f"segment_combine_{label}", path / "segment_combine.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build = types.SimpleNamespace(library=lambda name: lib)
    return mod, out.stdout + out.stderr


def make_inputs(dev):
    """(row, side, values, sorted ids, segments, combiner) of every case."""
    import torch

    import chip_smoke as cs
    from repro_torch.algorithms import REGISTRY, get_program
    from repro_torch.core import combiners as cb
    from repro_torch.graph import pgraph
    from repro_torch.kernels import ops
    from repro_torch.pregel.engine import Engine

    g = torch.Generator(device=dev).manual_seed(0)
    cases = []
    spec = REGISTRY["pagerank:scatter"]
    pr_graph = spec.make_graph(SCALE, 0)
    pr_pg = pgraph.partition_graph(pr_graph, W, "random", build=spec.build,
                                   device=dev)
    plan = pr_pg.scatter_out
    contrib = torch.rand((W, pr_pg.n_loc, 1), device=dev, generator=g)
    cases.append(("2", "send", contrib.gather(1, plan.edge_src.long()[
        ..., None]), plan.edge_seg, plan.u_cap, cb.SUM))
    cases.append(("2", "recv", torch.rand(plan.recv_sorted.shape + (1,),
                                          device=dev, generator=g),
                  plan.recv_sorted, pr_pg.n_loc, cb.SUM))
    spec = REGISTRY["wcc:basic"]
    wcc_pg = pgraph.partition_graph(spec.make_graph(SCALE, 0), W, "random",
                                    build=spec.build, device=dev)
    sv_plan = wcc_pg.scatter_out
    cases.append(("2a", "send", wcc_pg.global_ids().gather(
        1, sv_plan.edge_src.long())[..., None], sv_plan.edge_seg,
        sv_plan.u_cap, cb.MIN))
    cases.append(("2a", "recv", torch.randint(
        0, W * wcc_pg.n_loc, sv_plan.recv_sorted.shape + (1,), device=dev,
        dtype=torch.int32, generator=g), sv_plan.recv_sorted, wcc_pg.n_loc,
        cb.MIN))
    eng = Engine(mode="host", device=dev)
    spec = REGISTRY["msf:channels"]
    msf_pg = pgraph.partition_graph(spec.make_graph(SCALE, 0), W, "random",
                                    build=spec.build, device=dev)
    for row, calls in (
            ("2b", cs.captured_reduces(lambda: eng.run(
                get_program("msf:channels"), msf_pg, max_steps=1))),
            ("2c", cs.captured_reduces(lambda: eng.run(
                get_program("pagerank:basic", iters=30), pr_pg,
                max_steps=1)))):
        for side, (v, ids, n, comb) in zip(("send", "recv"), calls):
            vs, ss = cs.stable_sorted(v, ids)
            cases.append((row, side, vs, ss.contiguous(), n, comb))
    batched = batched_jobs(pr_graph, pr_pg, dev)
    spec, prog, pg, queries = batched["pagerank:personal"]
    calls = cs.captured_calls(ops, "segment_combine", lambda: eng.run_batch(
        prog, pg, queries, max_steps=1))
    for side, ((v, ids, n, comb), _) in zip(("send", "recv"), calls):
        cases.append(("2e", side, v, ids, n, comb))
    spec, prog, pg, queries = batched["sssp:prop"]
    calls = cs.first_calls(ops, "segment_combine", lambda: eng.run_batch(
        prog, pg, queries))
    for side, ((v, ids, n, comb), _) in zip(
            ("int_dst", "cut send", "cut recv"), calls):
        cases.append(("2f", side, v, ids, n, comb))
    return cases, batched


def batched_jobs(pr_graph, pr_pg, dev) -> dict:
    """(spec, program, partition, Q queries) of the two batched programs
    whose combines run on Q columns, as ``chip_smoke.py`` phase 4 runs
    them."""
    from repro_torch.algorithms import REGISTRY
    from repro_torch.graph import pgraph

    sssp = REGISTRY["sssp:basic"]
    graph = sssp.make_graph(SCALE, 0)
    jobs = {"pagerank:personal": (pr_graph, pr_pg),
            "sssp:prop": (graph, pgraph.partition_graph(
                graph, W, "random", build=sssp.build, device=dev))}
    out = {}
    for key, (graph, pg) in jobs.items():
        spec = REGISTRY[key]
        out[key] = (spec, spec.factory(**spec.inputs(graph, 0)), pg,
                    spec.queries(graph, 0, QUERIES))
    return out


def batched_walls(batched, dev) -> dict:
    """Walls in ms of each batched program: ``run_batch`` in host mode,
    and a fused (K = 64) replay after the run that captures it (the
    capture's wall beside it); outputs and per-query steps kept for the
    comparison across versions."""
    import torch

    import chip_smoke as cs
    from repro_torch.pregel.engine import Engine

    out = {}
    for key, (_, prog, pg, queries) in batched.items():
        host, ms = cs.timed(lambda: Engine(mode="host", device=dev).run_batch(
            prog, pg, queries))
        eng = Engine(mode="fused", chunk_size=64, device=dev)
        first, capture_ms = cs.timed(lambda: eng.run_batch(prog, pg,
                                                           queries))
        fused, fused_ms = cs.timed(lambda: eng.run_batch(prog, pg, queries))
        eng.clear_cache()
        same = fused.cache_hit and all(
            torch.equal(torch.as_tensor(a), torch.as_tensor(b))
            for a, b in zip(fused.outputs, host.outputs))
        out[key] = dict(
            steps=host.steps, host_ms=ms, host_loop_ms=1e3 * host.wall_time_s,
            fused_ms=fused_ms, fused_loop_ms=1e3 * fused.wall_time_s,
            fused_first_ms=capture_ms, fused_equals_host=same,
            outputs=[torch.as_tensor(x).cpu() for x in host.outputs],
            query_steps=host.query_steps.tolist())
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[],
                    metavar="LABEL=DIR",
                    help="another segment_combine.cu and segment_combine.py")
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds; odd rounds run the versions in reverse")
    ap.add_argument("--rows", default="2,2a,2b,2c,2e,2f",
                    help="kernel-table rows to time")
    ap.add_argument("--walls", default=None,
                    help="versions whose batched walls to time (default "
                         "all; 'none': no walls)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("segment_combine_ab: CUDA is not available", file=sys.stderr)
        return 2

    import chip_smoke as cs
    from repro_torch.kernels import build, ref as kref, segment_combine

    dev = torch.device("cuda")
    smi = cs.nvidia_smi()
    logs = build.build_all(("segment_combine",))
    versions = {}
    for spec in args.other:
        label, path = spec.split("=", 1)
        versions[label] = load_other(label, Path(path))
    versions["checkout"] = (segment_combine,
                            logs.get("segment_combine", ""))
    ptxas = {v: [ln.strip() for ln in log.splitlines() if "registers" in ln]
             for v, (_, log) in versions.items()}
    labels = list(versions)
    order = []
    for r in range(args.rounds):
        order += labels if r % 2 == 0 else labels[::-1]
    cases, batched = make_inputs(dev)
    rows = set(args.rows.split(","))
    cases = [c for c in cases if c[0] in rows]
    wall_labels = (set(labels) if args.walls is None
                   else set(args.walls.split(",")) - {"none"})
    want = [segment_combine.segment_combine_cuda(v, s, n, c)
            for _, _, v, s, n, c in cases]
    plain = [kref.segment_combine_ref(v, s, n, c) if c.name != "sum"
             else None for _, _, v, s, n, c in cases]
    print(f"segment_combine_ab: {smi} | order {' '.join(order)}", flush=True)
    for v, lines in ptxas.items():
        print(f"ptxas {v}: " + " | ".join(lines), flush=True)
    results = []
    for rnd, label in enumerate(order):
        mod = versions[label][0]
        for (row, side, v, s, n, c), w, p in zip(cases, want, plain):
            def fn(v=v, s=s, n=n, c=c):
                return mod.segment_combine_cuda(v, s, n, c)
            try:
                got = fn()
            except TypeError:  # this version has no such op
                continue
            same = cs.bits_equal(got, w) and (p is None
                                              or cs.bits_equal(got, p))
            res = dict(turn=rnd, version=label, row=row, side=side,
                       op=c.name, shape=list(v.shape), segments=n,
                       exact=same, cuda_ms=cs.cuda_ms(fn),
                       cuda_ms_cold=cs.cuda_ms_cold(fn),
                       kernels=cs.kernels_per_call(fn))
            results.append(res)
            split = "; ".join(f"{k[:40]} {m:g}x {ms:.4f}"
                              for k, (m, ms) in res["kernels"].items())
            print(f"{rnd} {label} {row} {side} {c.name} {res['shape']} into "
                  f"{n}: exact {same}, {res['cuda_ms']:.4f} ms warm, "
                  f"{res['cuda_ms_cold']:.4f} ms L2 flushed | {split}",
                  flush=True)
    # the batched walls, each version's kernel under the checkout's wrapper
    mine = segment_combine._library()
    walls, first = [], {}
    for rnd, label in enumerate(order):
        if label not in wall_labels:
            continue
        segment_combine._fns = (mine if label == "checkout"
                                else versions[label][0]._library())
        try:
            got = batched_walls(batched, dev)
        finally:
            segment_combine._fns = mine
        for key, x in got.items():
            outs = x.pop("outputs")
            ref_outs, ref_steps = first.setdefault(key, (outs,
                                                         x["query_steps"]))
            same = (x["fused_equals_host"] and x["query_steps"] == ref_steps
                    and all(cs.bits_equal(a, b)
                            for a, b in zip(outs, ref_outs)))
            walls.append(dict(x, turn=rnd, version=label, program=key,
                              exact=same))
            print(f"{rnd} {label} walls {key} Q={QUERIES} ({x['steps']} "
                  f"steps): host {x['host_ms']:.1f} ms (loop "
                  f"{x['host_loop_ms']:.1f}), fused replay "
                  f"{x['fused_ms']:.1f} ms (loop {x['fused_loop_ms']:.1f}; "
                  f"capture run {x['fused_first_ms']:.1f}), outputs equal "
                  f"{same}", flush=True)
    summary = {}
    for res in results:
        key = f"{res['version']} {res['row']}"
        for k in ("cuda_ms", "cuda_ms_cold"):
            summary.setdefault(key, {}).setdefault(k, {}).setdefault(
                res["turn"], 0.0)
            summary[key][k][res["turn"]] += res[k]
    for key, x in summary.items():
        print(f"{key} send + recv: warm "
              f"{[round(t, 4) for t in x['cuda_ms'].values()]} ms, flushed "
              f"{[round(t, 4) for t in x['cuda_ms_cold'].values()]} ms "
              f"(by turn)")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "segment_combine_ab.json").write_text(json.dumps(dict(
        nvidia_smi=smi, device=torch.cuda.get_device_name(0), order=order,
        ptxas=ptxas, results=results, summary=summary, walls=walls),
        indent=1))
    print(smi)
    return 0 if all(r["exact"] for r in results + walls) else 1


if __name__ == "__main__":
    sys.exit(main())
