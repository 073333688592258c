"""``python -m repro_torch`` — the port's registry-driven CLI.

Subcommands:

  list    every ported program (``algorithm:variant``), its channel class
          and the graph plans it needs.
  run     run one program on a generated problem instance, verify it
          against the host oracle (``--no-check`` skips that), and print
          the RunResult summary and the bytes of each channel.
  bench   run a set of programs (one per algorithm by default) and print
          paper-style rows (supersteps / messages / bytes / wall time),
          optionally writing JSON.
  bench-batch
          the batched query plane: run every batchable program (or
          ``--keys``) over Q queries, once as one ``Engine.run_batch``
          and once as Q serial single-query batches, check every lane
          against its serial run bit for bit (output, steps, bytes and
          messages) before timing anything, and print queries/s for both,
          the speedup, and the geomean speedup by channel class.
  serve   serve a Poisson stream of queries of a batchable program
          (``reach:basic``, ``sssp:basic``, ``pagerank:personal``,
          ``pj:reqresp``) through always-on lanes (``Engine.serve``),
          print throughput and latency, and check every served answer
          against a solo host-mode run.
  plan    the channel planner: fingerprint each program on its problem
          graph, lower its declared channels to a concrete Plan, and
          print the knob line or (``--explain``) the per-knob decision
          table with the predicted and measured cost of every candidate.
          ``--queries Q`` plans a Q-query batch; ``--no-calibrate`` skips
          the timed probes (corpus fits and defaults only). On the card
          the probes decide nothing and run only under ``--explain``.

``run`` and ``bench-batch`` take ``--mode host|fused|chunked`` (default
``fused``, as in the JAX CLI), ``bench`` a comma list ``--modes`` (one
engine a mode), and all three ``--chunk-size K`` (default 64): the
device modes run K supersteps a replay of a captured CUDA graph, every
program's inner loops as WHILE nodes inside it. ``run`` and ``bench``
take ``--plan manual|auto`` (auto: the cost-model planner chooses the
knobs a flag does not set) and print each run's knob line. ``run``
also takes ``--on-overflow raise|escalate`` (escalate: a channel that
overflows gets twice the capacity and the run starts again, printed as
"recovered"), and ``--checkpoint-every K --checkpoint-dir DIR`` /
``--resume FILE_OR_DIR`` (chunked mode, the default with either flag:
snapshots at chunk boundaries, and a resume from one, bit-identical to
the uninterrupted run). ``serve`` always runs the chunked serving
substrate, ``--serve-chunk`` supersteps a dispatch, and
``--route-batch union|lane`` picks how the lanes' routed channels share
their route passes (one pass over the union frontier, or one a lane).
Every command takes ``--mirror-threshold N|auto`` (hub mirroring of the
scatter and prop plans). Everything runs on the card unless ``--device
cpu`` is given.

Examples:

  python -m repro_torch list
  python -m repro_torch run msf --scale 12
  python -m repro_torch run pagerank:basic --scale 10 --device cpu
  python -m repro_torch run pagerank:scatter --scale 20 --mode fused \
      --repeat 2
  python -m repro_torch bench --scale 12 --keys sv:basic,sv:composed \\
      --json chiprun_out/bench.json
  python -m repro_torch serve sssp:basic --scale 20 --lanes 8 \\
      --serve-chunk 4
  python -m repro_torch serve reach:basic --device cpu --smoke
  python -m repro_torch run pagerank:personal --scale 20
  python -m repro_torch serve pagerank:personal --scale 20 --serve-chunk 4
  python -m repro_torch serve pj:reqresp --scale 20 --route-batch lane
  python -m repro_torch bench-batch --scale 20 --queries 32 \\
      --json chiprun_out/bench_batch.json
  python -m repro_torch run wcc:basic --scale 20 --checkpoint-every 2 \\
      --checkpoint-dir /tmp/ckpt
  python -m repro_torch run wcc:basic --scale 20 --resume /tmp/ckpt
  python -m repro_torch run sv:composed --scale 12 --on-overflow escalate
  python -m repro_torch run wcc:switch --scale 20 --plan auto
  python -m repro_torch bench --scale 12 --modes host,fused --plan auto
  python -m repro_torch plan --scale 20 --explain
  python -m repro_torch plan sssp:basic --scale 20 --queries 32 --explain
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from repro_torch.algorithms import (ALGORITHMS, BATCHED, DEFAULT_VARIANT,
                                    REGISTRY, resolve)
from repro_torch.graph import partition as partition_lib
from repro_torch.graph import pgraph
from repro_torch.pregel import checkpoint as ckpt_io
from repro_torch.pregel.engine import Engine
from repro_torch.pregel.serve import QueryQueue


def _fmt_bytes(b: int) -> str:
    return f"{b / 1e6:.3f} MB" if b >= 1e6 else f"{b} B"


def _summary(res) -> str:
    out = (f"steps {res.steps:5d}  msgs {res.total_msgs:10d}  "
           f"traffic {_fmt_bytes(res.total_bytes):>12s}  "
           f"wall {res.wall_time_s:7.3f}s  mode {res.mode}")
    if res.mode != "host":
        out += (f"  dispatches {res.dispatches}  " + (
            "[hit]" if res.cache_hit
            else f"[capture {res.compile_time_s:.3f}s]"))
    return out


def _knob_line(plan) -> str:
    """The resolved knob set a run ran under."""
    return (f"knobs: mode={plan.mode} chunk={plan.chunk_size} "
            f"use_kernel={plan.use_kernel} route_impl={plan.route_impl} "
            f"route_batch={plan.route_batch} "
            f"dense_threshold={plan.dense_threshold} [plan: {plan.source}]")


def _prepare(spec, args):
    """(graph, pg, inputs, program) of the spec's default problem."""
    graph = spec.make_graph(args.scale, args.seed)
    thr = args.mirror_threshold
    if thr is not None and thr != "auto":
        thr = int(thr)
    pg = pgraph.partition_graph(graph, args.workers, args.partitioner,
                                build=spec.build, device=args.device,
                                mirror_threshold=thr)
    inputs = spec.inputs(graph, args.seed)
    return graph, pg, inputs, spec.factory(**inputs)


def cmd_list(args) -> int:
    if args.json:
        out = {}
        for key, spec in sorted(REGISTRY.items()):
            graph = spec.make_graph(6, 0)
            out[key] = {
                "algorithm": spec.algorithm,
                "variant": spec.variant,
                "default": DEFAULT_VARIANT.get(spec.algorithm) == spec.variant,
                "build": list(spec.build),
                "channel_class": spec.channel_class,
                "channels": list(spec.factory(
                    **spec.inputs(graph, 0)).channel_names()),
            }
        print(json.dumps(out, indent=2))
        return 0
    print(f"{len(REGISTRY)} ported programs ({len(ALGORITHMS)} "
          f"algorithms):\n")
    for algo in ALGORITHMS:
        for key, spec in sorted(REGISTRY.items()):
            if spec.algorithm != algo:
                continue
            star = "*" if DEFAULT_VARIANT[algo] == spec.variant else " "
            plans = ",".join(spec.build) or "-"
            print(f"  {star} {key:22s} [{spec.channel_class:6s}] "
                  f"plans: {plans}")
    print("\n(* = default variant for `python -m repro_torch run "
          "<algorithm>`)")
    return 0


def cmd_run(args) -> int:
    spec = resolve(args.program)
    mode = args.mode
    if mode is None and (args.checkpoint_every or args.resume):
        mode = "chunked"  # checkpoints snapshot the chunked carry
    if mode is None and args.plan == "manual":
        mode = "fused"
    print(f"== {spec.key} (scale {args.scale}, W={args.workers}, "
          f"{args.partitioner} partition, {mode or 'planned'} mode, "
          f"{args.device}) ==")
    graph, pg, inputs, prog = _prepare(spec, args)
    print(f"graph: n={graph.n} edges={graph.num_edges}  program: {prog}")
    eng = Engine(mode=mode, chunk_size=args.chunk_size, device=args.device,
                 plan=args.plan, on_overflow=args.on_overflow)
    resume = args.resume
    if resume:
        if os.path.isdir(resume):
            resume = ckpt_io.latest(resume)
        if resume is None or not os.path.exists(resume):
            print(f"run: no checkpoint at {args.resume}")
            return 2
        print(f"resuming from {resume}")
    res = None
    for i in range(max(1, args.repeat)):
        res = eng.run(prog, pg, max_steps=args.max_steps,
                      checkpoint_every=args.checkpoint_every,
                      checkpoint_dir=args.checkpoint_dir, resume=resume)
        if i == 0:
            print(_knob_line(res.plan))
        print(f"run {i}: {_summary(res)}")
        if res.resumed_from:
            print(f"  resumed at superstep {res.resumed_from}")
        for ev in res.recovery or ():
            print(f"  recovered: overflow of {list(ev['channels'])} at "
                  f"superstep {ev['superstep']} -> cap_scales "
                  f"{ev['cap_scales']}")
    if args.repeat > 1:
        print(f"engine session: {eng.stats()}")
    for name in sorted(res.bytes_by_channel):
        print(f"  {name:32s} {res.bytes_by_channel[name]:12d} B "
              f"{res.msgs_by_channel[name]:10d} msgs")
    if args.check and spec.check is not None:
        t = time.perf_counter()
        spec.check(graph, pg, res, inputs)
        print(f"oracle: ok ({time.perf_counter() - t:.1f} s)")
    return 0


def cmd_bench(args) -> int:
    keys = (args.keys.split(",") if args.keys
            else [f"{a}:{DEFAULT_VARIANT[a]}" for a in ALGORITHMS])
    modes = args.modes.split(",")
    engines = {m: Engine(mode=m, chunk_size=args.chunk_size,
                         device=args.device, plan=args.plan)
               for m in modes}
    rows = []
    shown = set()
    print(f"== bench (scale {args.scale}, W={args.workers}, modes "
          f"{','.join(modes)}, plan {args.plan}, {args.device}) ==")
    for name in keys:
        spec = resolve(name)
        graph, pg, inputs, prog = _prepare(spec, args)
        for mode in modes:
            res = engines[mode].run(prog, pg, max_steps=args.max_steps)
            if res.plan.key() not in shown:
                shown.add(res.plan.key())
                print(f"  {_knob_line(res.plan)}")
            rows.append({
                "program": spec.key, "mode": res.mode,
                "supersteps": res.steps, "messages": res.total_msgs,
                "bytes": res.total_bytes, "wall_time_s": res.wall_time_s,
                "step_times_s": res.step_times_s,
                "dispatches": res.dispatches,
                "host_overhead_s": res.host_overhead_s,
                "compile_time_s": res.compile_time_s,
                "cache_hit": res.cache_hit,
                "plan": res.plan.to_json(),
            })
            print(f"  {spec.key:22s} {_summary(res)}")
    stats = {m: engines[m].stats() for m in modes}
    print(f"engine sessions: {stats}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"scale": args.scale, "workers": args.workers,
                       "device": args.device, "rows": rows,
                       "engines": stats}, f, indent=2)
        print(f"wrote {args.json}")
    return 0


def _same_lane(a, qa, b, qb) -> bool:
    """Lane ``qa`` of batch ``a`` equals lane ``qb`` of batch ``b``:
    output, steps, halt, and bytes and messages per channel."""
    return (np.array_equal(np.asarray(a.outputs[qa]),
                           np.asarray(b.outputs[qb]))
            and int(a.query_steps[qa]) == int(b.query_steps[qb])
            and bool(a.query_halted[qa]) == bool(b.query_halted[qb])
            and a.query_bytes(qa) == b.query_bytes(qb)
            and a.query_msgs(qa) == b.query_msgs(qb))


def cmd_bench_batch(args) -> int:
    named = args.programs or args.keys
    keys = named.split(",") if named else list(BATCHED)
    q = args.queries
    print(f"== bench-batch (scale {args.scale}, W={args.workers}, Q={q}, "
          f"{args.mode} mode, {args.device}) ==")
    rows = []
    for name in keys:
        spec = resolve(name)
        if spec.make_queries is None:
            print(f"  {spec.key:22s} (no query axis — skipped)")
            continue
        if args.channel_class not in ("all", spec.channel_class):
            continue
        graph, pg, _, prog = _prepare(spec, args)
        queries = spec.queries(graph, args.seed, q)
        eng = Engine(mode=args.mode, chunk_size=args.chunk_size,
                     device=args.device, route_batch=args.route_batch)
        batched = lambda: eng.run_batch(prog, pg, queries,
                                        max_steps=args.max_steps)
        one = lambda s: eng.run_batch(prog, pg, [s],
                                      max_steps=args.max_steps)
        # build both loops, then hold the batch to the serial runs lane by
        # lane before timing anything
        res_b = batched()
        serial = [one(s) for s in queries]
        for qi in range(len(queries)):
            if not _same_lane(res_b, qi, serial[qi], 0):
                print(f"  {spec.key}: lane {qi} ({spec.query_knob} "
                      f"{_short(queries[qi])}) differs from its serial run")
                return 1
        t0 = time.perf_counter()
        res_t = batched()
        t_batched = time.perf_counter() - t0
        t0 = time.perf_counter()
        for s in queries:
            one(s)
        t_serial = time.perf_counter() - t0
        row = {"program": spec.key, "q": len(queries),
               "channel_class": spec.channel_class,
               "route_batch": eng.route_batch, "mode": args.mode,
               "supersteps": res_b.steps,
               "queries_per_s_serial": len(queries) / t_serial,
               "queries_per_s_batched": len(queries) / t_batched,
               "speedup": t_serial / t_batched,
               "batched_wall_s": t_batched, "serial_wall_s": t_serial,
               "batched_cache_hit": res_t.cache_hit,
               "bytes": res_b.total_bytes}
        rows.append(row)
        print(f"  {spec.key:22s} [{spec.channel_class:6s}] "
              f"steps {res_b.steps:4d}  "
              f"serial {row['queries_per_s_serial']:8.1f} q/s  "
              f"batched {row['queries_per_s_batched']:8.1f} q/s  "
              f"speedup {row['speedup']:6.2f}x  [lanes bit-identical]")
    # speedup by channel class: static-plan channels batch as columns of
    # each launch; routed channels also share the union route pass
    by_class = {}
    for row in rows:
        by_class.setdefault(row["channel_class"], []).append(row["speedup"])
    geomeans = {}
    for cls in sorted(by_class):
        sp = by_class[cls]
        geomeans[cls] = float(np.exp(np.mean(np.log(sp))))
        print(f"  -- {cls:6s} ({len(sp)} programs): "
              f"geomean speedup {geomeans[cls]:6.2f}x  "
              f"(min {min(sp):.2f}x, max {max(sp):.2f}x)")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"scale": args.scale, "workers": args.workers,
                       "q": q, "mode": args.mode, "device": args.device,
                       "route_batch": args.route_batch or "union",
                       "geomean_speedup": geomeans, "rows": rows}, f,
                      indent=2)
        print(f"wrote {args.json}")
    return 0


def _short(query) -> str:
    """A query value for a message: a source id, or an array's head."""
    if isinstance(query, np.ndarray):
        return np.array2string(query, threshold=6)
    return str(query)


def cmd_serve(args) -> int:
    if args.smoke:
        # a small session with forced refills and every answer checked
        args.program = args.program or "reach:basic"
        args.scale, args.workers = 8, 4
        args.queries, args.lanes, args.serve_chunk = 12, 3, 3
    if args.program is None:
        print("serve: a program key is required (or use --smoke)")
        return 2
    spec = resolve(args.program)
    if spec.make_queries is None:
        print(f"serve: {spec.key} has no query axis")
        return 2
    chunk = args.serve_chunk or args.chunk_size or 64
    print(f"== serve {spec.key} (scale {args.scale}, W={args.workers}, "
          f"Q={args.queries}, lanes={args.lanes}, chunk={chunk}, "
          f"rate={args.rate}/step, route_batch={args.route_batch}, "
          f"{args.device}) ==")
    graph, pg, _, prog = _prepare(spec, args)
    schedule = spec.stream(graph, args.seed, args.queries, args.rate)
    eng = Engine(mode="chunked", chunk_size=chunk, device=args.device,
                 route_batch=args.route_batch)
    res = eng.serve(prog, pg, QueryQueue.from_schedule(schedule),
                    num_lanes=args.lanes, max_steps=args.max_steps)
    lat = res.latency_summary()
    print(f"served {res.num_queries} queries through {res.num_lanes} lanes: "
          f"{res.dispatches} dispatches, {res.supersteps} supersteps "
          f"(clock {res.clock}), wall {res.wall_time_s:.3f}s "
          f"[capture {res.compile_time_s:.3f}s]")
    print(f"  {res.queries_per_s:.1f} q/s   latency p50 "
          f"{lat['p50_steps']:.0f} / p99 {lat['p99_steps']:.0f} steps "
          f"({lat['p50_wall_s'] * 1e3:.1f} / {lat['p99_wall_s'] * 1e3:.1f} "
          f"ms); median dispatch {res.dispatch_median_s * 1e3:.2f} ms")
    if args.check:
        host = Engine(mode="host", device=args.device)
        for rec in res.records:
            solo = host.run(spec.factory(**{spec.query_knob: rec.query}), pg,
                            max_steps=args.max_steps)
            if not (np.array_equal(rec.output, solo.output)
                    and (rec.steps, rec.halted) == (solo.steps, solo.halted)
                    and rec.bytes_by_channel == solo.bytes_by_channel
                    and rec.msgs_by_channel == solo.msgs_by_channel):
                print(f"  query {rec.qid} ({spec.query_knob} "
                      f"{_short(rec.query)}) differs from its solo run")
                return 1
        print(f"  bit-identity: all {res.num_queries} served outputs, step "
              "counts and traffic match solo host-mode runs")
    return 0


def cmd_plan(args) -> int:
    from repro_torch.plan import Planner, cost_model, manual_plan

    keys = args.programs or ["wcc:switch", "sssp:basic"]
    planner = Planner(calibrate=not args.no_calibrate, explain=args.explain)
    print(f"== plan (scale {args.scale}, W={args.workers}, "
          f"Q={args.queries}, {args.device}) ==")
    print(f"config ladder (what plan=manual runs under): "
          f"{_knob_line(manual_plan())}")
    for name in keys:
        spec = resolve(name)
        graph, pg, _, prog = _prepare(spec, args)
        plan = planner.plan(prog, pg, num_queries=args.queries)
        print(f"\n{spec.key}  (n={graph.n}, edges={graph.num_edges}, "
              f"class={spec.channel_class})")
        print(plan.explain() if args.explain else _knob_line(plan))
    if not args.no_calibrate:
        print(f"\ncalibration cache: {cost_model.cache_dir()}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_list = sub.add_parser("list", help="list the ported programs")
    p_list.add_argument("--json", action="store_true")
    p_list.set_defaults(fn=cmd_list)

    def common(p):
        p.add_argument("--scale", type=int, default=10,
                       help="graph scale (n = 2^scale)")
        p.add_argument("--workers", type=int, default=8)
        p.add_argument("--partitioner", default="random",
                       choices=sorted(partition_lib.PARTITIONERS))
        p.add_argument("--max-steps", type=int, default=None)
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                       help="where the graph and the run live (default: "
                            "the card)")
        p.add_argument("--chunk-size", type=int, default=None,
                       help="supersteps a dispatch of the fused/chunked "
                            "modes covers (default 64; unset lets "
                            "--plan auto choose)")
        p.add_argument("--mirror-threshold", default=None,
                       help="hub-mirroring degree threshold for the "
                            "scatter/prop plans: an int, 'auto', or unset "
                            "(off)")

    def plan_flag(p):
        p.add_argument("--plan", default="manual",
                       choices=("manual", "auto"),
                       help="knob source: manual = flags/env/defaults, "
                            "auto = the cost-model planner (explicit "
                            "flags still win)")

    def modes(p):
        p.add_argument("--mode", default="fused",
                       choices=("host", "fused", "chunked"),
                       help="execution mode (default: fused)")

    p_run = sub.add_parser("run", help="run one program, verify the oracle")
    p_run.add_argument("program",
                       help="algorithm (default variant) or algorithm:variant")
    common(p_run)
    p_run.add_argument("--mode", default=None,
                       choices=("host", "fused", "chunked"),
                       help="execution mode (default: fused, chunked "
                            "with a checkpoint flag, or the planner's "
                            "choice under --plan auto)")
    plan_flag(p_run)
    p_run.add_argument("--repeat", type=int, default=1,
                       help="run the program this many times")
    p_run.add_argument("--no-check", dest="check", action="store_false",
                       help="skip the host-oracle verification")
    p_run.add_argument("--on-overflow", default="raise",
                       choices=("raise", "escalate"),
                       help="channel-capacity overflow policy: escalate "
                            "doubles the overflowed caps and runs again")
    p_run.add_argument("--checkpoint-every", type=int, default=None,
                       help="snapshot the run every K supersteps "
                            "(chunked mode; needs --checkpoint-dir)")
    p_run.add_argument("--checkpoint-dir", default=None,
                       help="directory checkpoints are written into")
    p_run.add_argument("--resume", default=None,
                       help="checkpoint file (or directory: the newest "
                            "in it) to resume from, bit-identical to the "
                            "uninterrupted run")
    p_run.set_defaults(fn=cmd_run)

    p_bench = sub.add_parser("bench", help="bench programs")
    p_bench.add_argument("--keys", default=None,
                         help="comma list of programs (default: one per "
                              "algorithm)")
    common(p_bench)
    p_bench.add_argument("--modes", "--mode", dest="modes", default="fused",
                         help="comma list of execution modes, one engine "
                              "a mode (default: fused)")
    plan_flag(p_bench)
    p_bench.add_argument("--json", default=None, help="write rows to JSON")
    p_bench.set_defaults(fn=cmd_bench)

    p_bb = sub.add_parser(
        "bench-batch",
        help="batched query plane: run_batch against serial Q=1 runs")
    p_bb.add_argument("--keys", default=None,
                      help="comma list of batched programs (default: "
                           "every program with a query axis)")
    p_bb.add_argument("--programs", default=None,
                      help="alias for --keys (takes precedence)")
    common(p_bb)
    modes(p_bb)
    p_bb.add_argument("--channel-class", default="all",
                      choices=("static", "routed", "all"),
                      help="only bench programs of this data-plane family")
    p_bb.add_argument("--route-batch", default=None,
                      choices=("union", "lane"),
                      help="how batched routed channels share their route "
                           "passes (default: REPRO_ROUTE_BATCH, else "
                           "union)")
    p_bb.add_argument("--queries", type=int, default=16,
                      help="batch size Q")
    p_bb.add_argument("--json", default=None, help="write rows to JSON")
    p_bb.set_defaults(fn=cmd_bench_batch)

    p_serve = sub.add_parser(
        "serve", help="continuous-batching query service under a Poisson "
                      "workload")
    p_serve.add_argument("program", nargs="?", default=None,
                         help="a batchable program (algorithm or "
                              "algorithm:variant)")
    common(p_serve)
    p_serve.add_argument("--queries", type=int, default=32,
                         help="queries in the arrival stream")
    p_serve.add_argument("--lanes", type=int, default=8,
                         help="always-on query lanes (the batch width)")
    p_serve.add_argument("--serve-chunk", type=int, default=None,
                         help="supersteps a dispatch = admission "
                              "granularity (default: --chunk-size)")
    p_serve.add_argument("--rate", type=float, default=1.0,
                         help="Poisson arrival rate (queries a superstep)")
    p_serve.add_argument("--route-batch", default="union",
                         choices=("union", "lane"),
                         help="how the lanes' routed channels share their "
                              "route passes: one over the union frontier "
                              "(default) or one a lane")
    p_serve.add_argument("--no-check", dest="check", action="store_false",
                         help="skip checking each answer against a solo "
                              "run")
    p_serve.add_argument("--smoke", action="store_true",
                         help="a small session (scale 8, 12 queries, 3 "
                              "lanes, chunk 3), every answer checked")
    p_serve.set_defaults(fn=cmd_serve)

    p_plan = sub.add_parser(
        "plan", help="lower programs' channels to concrete Plans "
                     "(decision table)")
    p_plan.add_argument("programs", nargs="*", default=None,
                        help="programs to plan (default: wcc:switch, "
                             "sssp:basic)")
    common(p_plan)
    p_plan.add_argument("--queries", type=int, default=0,
                        help="plan for a Q-query batch (0 = single run)")
    p_plan.add_argument("--explain", action="store_true",
                        help="print the full per-knob decision table "
                             "(candidates, predicted and measured cost)")
    p_plan.add_argument("--no-calibrate", action="store_true",
                        help="skip the timed calibration probes: corpus "
                             "fits and defaults only")
    p_plan.set_defaults(fn=cmd_plan)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
