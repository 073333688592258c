#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
drives the port's main paths on the card: R-MAT generator →
partitioner → plans → channels → host-driven superstep loop →
``Engine.run`` → oracle check for ``wcc:basic``, ``pagerank:scatter`` and
the composed S-V program ``sv:composed`` (RequestRespond, ScatterCombine,
CombinedMessage and full pointer jumping under one ``compose.Stacked``),
and the batched query plane — ``Engine.run_batch`` of Q=32 sources of
``reach:basic`` and ``sssp:basic`` through the union CombinedMessage —
checked against solo runs and the host oracles. Phases, one line each:

  1. environment and kernel build;
  2. each kernel against its plain PyTorch version on the card, the two
     bucket kernels at the main path's full shapes on random, sorted,
     one-bucket, all-sentinel and out-of-range keys, and
     ``segment_combine`` as the S-V neighbour minimum's int32 ``min`` at
     the scale-20 S-V plan (sender and receiver side: vertex ids,
     INT32_MAX/INT32_MIN, one hub segment, every id dropped);
  3. reference traffic counts at scale 12, W=8 (exact), solo and batched
     (every batched lane bit-identical to its solo run), and the nine
     composition-layer programs (six S-V variants, ``wcc:switch``,
     ``pj:basic``/``reqresp``) with their bytes per channel, the S-V
     variants' labels identical and ``sv:composed`` ahead of ``sv:basic``
     on supersteps and bytes;
  4. the main paths at R-MAT scale 20, W=8, checked against the host
     oracles, each with its kernels' launch counts (counts reset just
     before the path and read just after): pagerank run twice
     (bit-identical); ``sv:composed`` against ``sv:basic`` (supersteps,
     bytes, ms a superstep, wall time, peak memory), ``wcc:switch`` and
     ``pj:reqresp`` beside them; every lane of the batched runs
     bit-identical to its solo run, queries/s batched and solo, peak
     device memory;
  5. each kernel's time against its plain version, its bound and a
     PyTorch yardstick at the scale-20 shapes (the bucket kernels also on
     random keys, warm and L2-flushed, and checked to run one device
     kernel a call, fills and memsets counted; ``segment_combine`` also
     as int32 ``min`` at the S-V plan), and one run of each program (the
     batched sssp and ``sv:composed`` among them) under torch.profiler
     (device busy share, top kernels and aten ops;
     ``chiprun_out/profile_*.txt``).

Then the kernel table as one JSON line, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``. Any failed check
raises: the script exits non-zero and prints no result. Details go to
``chiprun_out/chip_smoke.json``. It needs CUDA and the repository's
``src/`` beside it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
W = 8
FULL_SCALE = 20
NQ = 32  # queries per batched run
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
INT32_MAX, INT32_MIN = 2**31 - 1, -2**31

# (supersteps, messages, bytes, bytes by channel) of the composition
# layer's programs at scale 12, W=8, random partitioner: the S-V variants
# and wcc:switch on rmat(12, edge_factor=8, seed=2) symmetrised, pointer
# jumping on the registry's scale-12 forest (the JAX package's host-mode
# Engine gives these counts)
SV_REFS = {
    "sv:composed": (3, 39526, 159356, {
        "sv/neighbor_min": 132204, "sv/jump": 21776, "sv/merge": 2504,
        "sv/pointer/request": 1436, "sv/pointer/respond": 1436}),
    "sv:basic": (4, 78907, 631256, {
        "combined_message": 352544, "basic_reqresp/request": 138112,
        "basic_reqresp/respond": 138112, "merge_message": 2488}),
    "sv:reqresp": (4, 49005, 373536, {
        "combined_message": 352544, "request_respond/request": 9252,
        "request_respond/respond": 9252, "merge_message": 2488}),
    "sv:scatter": (4, 78907, 454984, {
        "scatter_combine": 176272, "basic_reqresp/request": 138112,
        "basic_reqresp/respond": 138112, "merge_message": 2488}),
    "sv:both": (4, 49005, 197264, {
        "scatter_combine": 176272, "request_respond/request": 9252,
        "request_respond/respond": 9252, "merge_message": 2488}),
    "sv:monolithic": (4, 222294, 1778352, {
        "mono_message": 1502128, "basic_reqresp/request": 138112,
        "basic_reqresp/respond": 138112}),
    "wcc:switch": (6, 55092, 220396, {
        "wcc/dense/scatter_combine": 220340,
        "wcc/sparse/combined_message": 56}),
    "pj:basic": (6, 42990, 343920, {
        "basic_reqresp/request": 171960, "basic_reqresp/respond": 171960}),
    "pj:reqresp": (6, 14346, 57384, {
        "request_respond/request": 28692, "request_respond/respond": 28692}),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


HOLD_CYCLES = 1_000_000  # ~0.5 ms of the card's clock per queued call


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back launches
    (CUDA events). A spin kernel holds the card while the host queues all
    ``reps`` calls, so a call whose Python wrapper takes longer than its
    kernels is still timed on the device, not on the host."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES * reps)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_cold(fn, reps: int = 20) -> float:
    """Mean device time of one ``fn()`` after the 50 MB L2 cache was
    flushed (a 256 MB buffer written just before each launch)."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def traced(fn, attempts: int = 3):
    """``fn()`` under torch.profiler (CPU and CUDA activity): its result
    and the trace's ``key_averages()``. Every traced call here launches
    device kernels, so a trace without a single device event is a
    failure of the tracer, not a measurement: it is taken again, up to
    ``attempts`` times, and then the run fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        if any(e.device_type == DeviceType.CUDA for e in events):
            return out, events
        print("chip_smoke: torch.profiler recorded no device event; "
              "tracing again", file=sys.stderr, flush=True)
    raise SmokeFailure(
        f"torch.profiler recorded no device event in {attempts} traces")


def kernels_per_call(fn, calls: int = 10) -> dict:
    """{device kernel name: [launches, device ms] per call} of ``fn()``,
    from torch.profiler over ``calls`` calls (fills and memsets count)."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    _, events = traced(lambda: [fn() for _ in range(calls)])
    return {e.key[:80]: [e.count / calls,
                         e.self_device_time_total / 1e3 / calls]
            for e in events if e.device_type == DeviceType.CUDA}


def bucket_edge_cases(dev, g, lkeys) -> list:
    """``bucket_ranks`` at wcc's route-key shape (W, 2^21) and
    ``bucket_ranks_lanes`` at the batched plane's (W, M, Q), each exact
    against its plain version where a chained scan over tiles can break:
    random keys, sorted runs, one hub bucket (ranks up to M - 1 down a
    row's whole chain of tiles), every key the sentinel, keys outside
    [0, W] (rank 0, no count); for the lanes kernel also the main path's
    union keys ``lkeys``. Membership: half the lanes of each entry that is
    not a sentinel. Returns the case names."""
    import torch
    from repro_torch.kernels import ops, ref as kref

    def cases(shape):
        rnd = torch.randint(0, W + 1, shape, device=dev, dtype=torch.int32,
                            generator=g)
        bad = rnd.clone()
        pick = torch.rand(shape, device=dev, generator=g)
        bad[pick < 0.05] = -1
        bad[(pick >= 0.05) & (pick < 0.1)] = W + 3
        return {"random": rnd, "sorted": torch.sort(rnd, dim=1)[0],
                "hub": torch.full_like(rnd, 3),
                "all sentinel": torch.full_like(rnd, W), "out of range": bad}

    names = []
    for what, keys in cases((W, 1 << 21)).items():
        got, want = ops.bucket_ranks(keys, W), kref.bucket_ranks_ref(keys, W)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"bucket_ranks {what} at ({W}, 2^21) differs from plain")
        names.append(f"bucket_ranks {what}")
    for what, keys in dict(cases(tuple(lkeys.shape)), union=lkeys).items():
        lanes = ((torch.rand(keys.shape + (NQ,), device=dev, generator=g)
                  < 0.5) & (keys != W)[..., None])
        got = ops.bucket_ranks_lanes(keys, lanes, W)
        want = kref.bucket_ranks_lanes_ref(keys, lanes, W)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"bucket_ranks_lanes {what} at {tuple(lanes.shape)} differs "
              "from plain")
        names.append(f"bucket_ranks_lanes {what}")
    return names


def timed(fn):
    """``fn()`` and its host wall time in ms, from a synced device to the
    device's end of the run."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, 1e3 * (time.perf_counter() - t0)


def same_run(a, b) -> bool:
    """Two runs of one query: equal outputs, steps, halt flags and
    per-channel bytes and messages."""
    import numpy as np

    return (np.array_equal(a[0], b[0]) and a[1:] == b[1:])


def lane_of(res, qi):
    """(output, steps, halted, bytes, msgs) of lane ``qi`` of a batched
    result."""
    return (res.outputs[qi], int(res.query_steps[qi]),
            bool(res.query_halted[qi]), res.query_bytes(qi),
            res.query_msgs(qi))


def solo_of(res):
    return (res.output, res.steps, res.halted, res.bytes_by_channel,
            res.msgs_by_channel)


def segment_edge_cases(plan, g, seg_case) -> dict:
    """``segment_combine`` against its plain version where a tiled
    reduction can break, at the pagerank plan's sender shape (W,
    e_cap = 2^20): a hub of 2^20 entries in one row, every id dropped,
    N = 1, long gaps of empty segments at tile edges, a dropped tail of
    half the row, D = 1, 3 and 5, NaN and +-inf for min/max, int32 sums
    that wrap. Exact, except float32 sums of random values (rtol 1e-4,
    atol 1e-5: reassociation only). Small-integer values make every
    other float32 sum exact in any order."""
    import torch

    w, e = plan.edge_seg.shape
    dev, n = plan.edge_seg.device, plan.u_cap
    pos = torch.arange(e, device=dev, dtype=torch.int32)
    tile = 2048  # the kernel's tile: 256 threads x 8 entries

    def rand(d=1):
        return torch.rand((w, e, d), device=dev, generator=g)

    small = torch.randint(-3, 4, (w, e, 1), device=dev, generator=g).float()
    hub = plan.edge_seg.clone()
    hub[0] = 0  # row 0: one segment of 2^20 entries
    gaps = ((pos // tile) * 5000 + (pos % tile) // 256 * 20).expand(w, e)
    half = torch.sort(torch.randint(0, n, (w, e // 2), device=dev,
                                    generator=g, dtype=torch.int32))[0]
    tail = torch.cat([half, torch.full_like(half, n)], dim=1)
    special = rand()
    pick = rand()
    special[pick < 0.01] = float("nan")
    special[(pick >= 0.01) & (pick < 0.03)] = float("inf")
    special[(pick >= 0.03) & (pick < 0.05)] = -float("inf")
    wrap = torch.randint(2**30, 2**31 - 1, (w, e, 1), device=dev,
                         generator=g, dtype=torch.int32)
    all3 = ("sum", "min", "max")
    cases = [("hub", small, hub, n, all3),
             ("hub i32", small.int(), hub, n, ("sum",)),
             ("all dropped", small, torch.full_like(hub, n), n, all3),
             ("all dropped bool", rand() < 0.5, torch.full_like(hub, -1), n,
              ("or",)),
             ("N=1", small, (plan.edge_seg >= n // 2).int(), 1, all3),
             ("tile-edge gaps", small, gaps, int(gaps.max()) + 1, all3),
             ("half-row tail", small, tail, n, all3),
             ("half-row tail bool", rand() < 0.5, tail, n, ("or",)),
             ("NaN/inf", special, plan.edge_seg, n, ("min", "max")),
             ("int32 wrap", wrap, plan.edge_seg, n, ("sum",))]
    for d in (3, 5):
        cases.append((f"D={d}", rand(d), plan.edge_seg, n, ("min", "max")))
        cases.append((f"D={d} i32", (rand(d) * 2000 - 1000).int(),
                      plan.edge_seg, n, ("sum",)))
    for what, vals, seg, nseg, combs in cases:
        for comb in combs:
            seg_case(vals, seg, nseg, comb, what=what)
    err = max(seg_case(rand(d), plan.edge_seg, n, "sum", 1e-4, 1e-5,
                       f"D={d}") for d in (1, 3, 5))
    return dict(max_abs_err=err, cases=len(cases) + 3)


def canon(labels):
    """Component labels renumbered by first occurrence (numpy): two
    labelings of one partition into components give equal arrays."""
    import numpy as np

    _, first, inv = np.unique(labels, return_index=True, return_inverse=True)
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first)] = np.arange(len(first))
    return rank[inv.reshape(-1)]


def sv_min_cases(plan, n_loc, g, seg_case) -> list:
    """``segment_combine`` as the S-V neighbour minimum's int32 ``min`` on
    the scatter plan, exact against its plain version: the sender side
    (per-edge vertex ids into ``u_cap`` segments, as the channel gathers
    them) and the receiver side (the wire into ``n_loc`` segments in
    ``recv_sorted`` order), each with vertex ids, INT32_MAX (the identity,
    what pads carry) and INT32_MIN among them, one hub segment over row
    0, and every id dropped. Returns the case names."""
    import torch

    dev = plan.edge_seg.device
    ids = torch.arange(plan.num_workers * n_loc, dtype=torch.int32,
                       device=dev).reshape(plan.num_workers, n_loc)
    sides = {
        "send": (ids.gather(1, plan.edge_src.long())[..., None],
                 plan.edge_seg, plan.u_cap),
        "recv": (torch.randint(0, plan.num_workers * n_loc,
                               plan.recv_sorted.shape + (1,), device=dev,
                               generator=g, dtype=torch.int32),
                 plan.recv_sorted, n_loc)}
    names = []
    for side, (vals, seg, n) in sides.items():
        extreme = vals.clone()
        pick = torch.rand(vals.shape, device=dev, generator=g)
        extreme[pick < 0.3] = INT32_MAX
        extreme[(pick >= 0.3) & (pick < 0.4)] = INT32_MIN
        hub = seg.clone()
        hub[0] = 0
        for what, v, sg in (("ids", vals, seg), ("extremes", extreme, seg),
                            ("hub", vals, hub),
                            ("all dropped", vals, torch.full_like(seg, n))):
            seg_case(v, sg, n, "min", what=f"sv {side} {what}")
            names.append(f"{side} {what}")
    return names


def profile_runs(jobs, out_dir: Path) -> dict:
    """One traced run per (key, run function, untraced wall ms) under
    torch.profiler, and the kernels and aten ops that take the device
    time. Two busy shares, both for one stream: ``busy_share`` is the
    traced run's device time over its own wall time (one run, slowed by
    the profiler); ``busy_vs_untraced`` is the same device time over the
    wall time of the untraced phase-4 run of that program (two runs)."""
    from torch.autograd import DeviceType

    def dev_us(e, total=False):
        name = "device_time_total" if total else "self_device_time_total"
        return getattr(e, name)

    out = {}
    for key, fn, untraced_ms in jobs:
        (res, wall_ms), events = traced(lambda: timed(fn))
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        ops_ = [e for e in events if e.device_type == DeviceType.CPU
                and e.key.startswith("aten::")]
        device_ms = sum(dev_us(e) for e in kernels) / 1e3
        top_k = sorted(kernels, key=dev_us, reverse=True)[:12]
        top_o = sorted(ops_, key=lambda e: dev_us(e, True), reverse=True)[:12]
        out[key] = dict(
            steps=res.steps, wall_ms=wall_ms, device_ms=device_ms,
            busy_share=device_ms / wall_ms, untraced_wall_ms=untraced_ms,
            busy_vs_untraced=device_ms / untraced_ms,
            kernels=[(e.key[:90], dev_us(e) / 1e3, e.count) for e in top_k],
            aten_ops=[(e.key, dev_us(e, True) / 1e3, e.count) for e in top_o])
        rows = "\n".join(f"{ms:10.3f} ms {n:6d}x  {k}"
                         for k, ms, n in out[key]["kernels"] +
                         [("--- aten ops (device time incl. children)", 0, 0)]
                         + out[key]["aten_ops"])
        stem = key.replace(":", "_").replace(" ", "_")
        (out_dir / f"profile_{stem}.txt").write_text(
            f"{key}: {res.steps} steps, traced wall {wall_ms:.3f} ms, device "
            f"{device_ms:.3f} ms, busy {device_ms / wall_ms:.3f}; untraced "
            f"wall {untraced_ms:.3f} ms, device/untraced "
            f"{device_ms / untraced_ms:.3f}\n{rows}\n")
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    from repro_torch.algorithms import REGISTRY, common, get_program
    from repro_torch.algorithms.common import pj_converge
    from repro_torch.core import combiners as cb
    from repro_torch.core import compose
    from repro_torch.core import routing
    from repro_torch.graph import generators as gen, pgraph
    from repro_torch.kernels import build, ops, ref as kref
    from repro_torch.pregel.engine import Engine

    dev = torch.device("cuda")
    detail = {}

    # -- 1. environment and build ------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    t = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t
    regs = [ln.strip() for log in logs.values() for ln in log.splitlines()
            if "registers" in ln]
    detail["env"] = dict(device=name, nvidia_smi=smi, torch=torch.__version__,
                         cuda=torch.version.cuda, build_s=build_s,
                         ptxas=regs)
    print(f"[1/5] env: {name} | {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | kernels built in {build_s:.1f} s "
          f"({len(logs)} nvcc)", flush=True)

    # -- 2. kernels against their plain versions on the card ----------------
    t = time.perf_counter()
    pr_graph = REGISTRY["pagerank:scatter"].make_graph(FULL_SCALE, 0)
    pr_pg = pgraph.partition_graph(pr_graph, W, "random",
                                   build=REGISTRY["pagerank:scatter"].build)
    pr_host_s = time.perf_counter() - t
    plan = pr_pg.scatter_out
    # the wcc:basic partition: its recipe and plans are the S-V ones, so
    # sv:composed, sv:basic and wcc:switch run on it too
    t_w = time.perf_counter()
    wcc_spec = REGISTRY["wcc:basic"]
    check(all(REGISTRY[k].make_graph is wcc_spec.make_graph
              and REGISTRY[k].build == wcc_spec.build
              for k in ("sv:composed", "sv:basic", "wcc:switch")),
          "the S-V programs no longer share wcc:basic's recipe and plans")
    wcc_graph = wcc_spec.make_graph(FULL_SCALE, 0)
    wcc_pg = pgraph.partition_graph(wcc_graph, W, "random",
                                    build=wcc_spec.build)
    wcc_host_s = time.perf_counter() - t_w
    sv_plan = wcc_pg.scatter_out
    g = torch.Generator(device=dev).manual_seed(0)
    errs = {}

    # the batched plane's union route keys at scale 20: the owners of the
    # union of every edge destination (u_cap = min(Q * e_cap, W * n_loc),
    # as the union CombinedMessage sizes it), half of the Q lanes member
    # of each real entry, none of a sentinel entry
    raw = pr_pg.raw_out
    n_total = W * pr_pg.n_loc
    union_cap = min(NQ * raw.e_cap, n_total)
    u_dst, _ = routing.dedup_dense(raw.dst_global, raw.mask, n_total,
                                   union_cap)
    lkeys = torch.where(u_dst != routing.BIG, u_dst // pr_pg.n_loc,
                        W).to(torch.int32)
    lanes = ((torch.rand((W, union_cap, NQ), device=dev, generator=g)
              < 0.5) & (lkeys < W)[..., None])
    bucket_cases = bucket_edge_cases(dev, g, lkeys)
    errs["bucket_ranks"] = errs["bucket_ranks_lanes"] = 0.0

    def seg_case(vals, seg, n, comb, rtol=0.0, atol=0.0, what=""):
        """Kernel against plain: exact (NaN where the plain version has
        NaN) unless a tolerance is given; the max |error| of a float sum."""
        out = ops.segment_combine(vals, seg, n, comb)
        want = kref.segment_combine_ref(vals, seg, n, comb)
        torch.testing.assert_close(
            out, want, rtol=rtol, atol=atol, equal_nan=True,
            msg=lambda m: f"segment_combine {what} {comb}: {m}")
        if rtol == 0.0 and atol == 0.0:
            return 0.0
        return float((out - want).abs().max())

    e_cap, u_cap = plan.e_cap, plan.u_cap
    recv_n = W * plan.slot_cap
    f32 = torch.rand((W, e_cap, 1), device=dev, generator=g)
    i32 = torch.randint(-1000, 1000, (W, e_cap, 1), device=dev,
                        dtype=torch.int32, generator=g)
    # f32 sum: sums of up to a hub's in-degree of U[0, 1) values in another
    # order than index_add's atomics — reassociation only
    e1 = seg_case(f32, plan.edge_seg, u_cap, "sum", 1e-4, 1e-5, "send f32")
    rv = torch.rand((W, recv_n, 1), device=dev, generator=g)
    e2 = seg_case(rv, plan.recv_sorted, pr_pg.n_loc, "sum", 1e-4, 1e-5,
                  "recv f32")
    for comb in ("min", "max"):
        seg_case(f32, plan.edge_seg, u_cap, comb, what="send f32")
    seg_case(i32, plan.edge_seg, u_cap, "sum", what="send i32")
    inf = float("inf")
    probe_v = torch.tensor([[inf], [inf], [5.0], [inf], [2.0], [inf]],
                           device=dev)
    probe_s = torch.tensor([0, 0, 1, 2, 2, 3], device=dev, dtype=torch.int32)
    got = ops.segment_combine(probe_v, probe_s, 4, "min")
    check(torch.equal(got[:, 0], torch.tensor([inf, 5.0, 2.0, inf],
                                              device=dev)),
          f"fault-1 probe: min gave {got[:, 0].tolist()}")
    for comb in ("sum", "max"):
        seg_case(probe_v, probe_s, 4, comb, what="fault-1 probe")
    empty_s = torch.tensor([1, 1, 4, 7, 9], device=dev, dtype=torch.int32)
    for vals in (torch.tensor([[1.5], [2.0], [-3.0], [4.0], [5.0]],
                              device=dev),
                 torch.tensor([[3], [-2], [7], [1], [1]], device=dev,
                              dtype=torch.int32)):
        for comb in ("sum", "min", "max"):
            seg_case(vals, empty_s, 6, comb, what="empty/dropped")
    seg_case(torch.tensor([True, False, False, True, True], device=dev),
             empty_s, 6, "or", what="empty/dropped bool")
    edge = segment_edge_cases(plan, g, seg_case)
    sv_cases = sv_min_cases(sv_plan, wcc_pg.n_loc, g, seg_case)
    # two runs of pagerank's send side: bit-identical (no float atomics)
    send_a = ops.segment_combine(f32, plan.edge_seg, u_cap, "sum")
    send_b = ops.segment_combine(f32, plan.edge_seg, u_cap, "sum")
    check(torch.equal(send_a, send_b),
          "segment_combine send side differs between two runs")
    torch.cuda.synchronize()
    errs["segment_combine"] = max(e1, e2, edge["max_abs_err"])
    detail["kernel_checks"] = dict(errs, pagerank_host_setup_s=pr_host_s,
                                   wcc_host_setup_s=wcc_host_s,
                                   bucket_cases=bucket_cases,
                                   sv_int32_min_cases=sv_cases)
    print(f"[2/5] kernels vs plain on the card: bucket_ranks ({W}, 2^21) "
          f"and bucket_ranks_lanes ({W}, {union_cap}, {NQ}) exact on "
          f"{len(bucket_cases)} cases (random, sorted, one hub bucket, all "
          f"sentinel, out of range; the lanes kernel also on the main "
          f"path's union keys); "
          f"segment_combine at the pagerank plan (W={W}, "
          f"e_cap={e_cap}, u_cap={u_cap}, recv {recv_n}) f32 sum max|err| "
          f"{errs['segment_combine']:.3g} (rtol 1e-4, atol 1e-5), min/max/"
          f"int32 sum exact, fault-1 probe [inf,5,2,inf], empty segments "
          f"hold the identity; {edge['cases']} edge cases at ({W}, {e_cap}) "
          f"(a 2^20-entry hub, all dropped, N=1, tile-edge gaps, half-row "
          f"tail, D=1/3/5, NaN/inf, int32 wrap) exact but for random f32 "
          f"sums; send side bit-identical in two runs; int32 min at the "
          f"S-V plan (send ({W}, {sv_plan.e_cap}) into {sv_plan.u_cap}, "
          f"recv {tuple(sv_plan.recv_sorted.shape)} into {wcc_pg.n_loc}) "
          f"exact on {len(sv_cases)} cases (ids, INT32_MAX/MIN, one hub, "
          f"all dropped) ({time.perf_counter() - t:.1f} s)", flush=True)

    # -- 3. reference counts at scale 12 ------------------------------------
    t = time.perf_counter()
    eng = Engine()
    refs = {
        "wcc:basic": (gen.rmat(12, edge_factor=8, seed=2).symmetrized(), {},
                      (6, 42027, 336216)),
        "pagerank:scatter": (gen.rmat(12, edge_factor=12, seed=1,
                                      directed=True), {"iters": 10},
                             (10, 98130, 392520)),
    }
    counts = {}
    for key, (graph, knobs, want) in refs.items():
        pg = pgraph.partition_graph(graph, W, "random",
                                    build=REGISTRY[key].build)
        res = eng.run(get_program(key, **knobs), pg)
        got = (res.steps, res.total_msgs, res.total_bytes)
        check(got == want, f"{key} scale-12 counts {got} != {want}")
        counts[key] = dict(steps=got[0], msgs=got[1], bytes=got[2],
                           bytes_by_channel=res.bytes_by_channel)
    # the batched plane: Q=32 sources of the registry recipe, W=8 (the
    # JAX package's host-mode run_batch gives these counts)
    t_b = time.perf_counter()
    batch_refs = {"reach:basic": (7, 118509, 948072),
                  "sssp:basic": (16, 333297, 2666376)}
    for key, want in batch_refs.items():
        spec = REGISTRY[key]
        graph = spec.make_graph(12, 0)
        pg = pgraph.partition_graph(graph, W, "random", build=spec.build)
        queries = spec.queries(graph, 0, NQ)
        res = eng.run_batch(spec.factory(), pg, queries)
        got = (res.steps, res.total_msgs, res.total_bytes)
        check(got == want, f"{key} scale-12 batched counts {got} != {want}")
        check(res.num_pad_lanes == 0, f"{key}: {res.num_pad_lanes} pad lanes")
        for qi, source in enumerate(queries):
            solo = eng.run(spec.factory(source=source), pg)
            check(same_run(lane_of(res, qi), solo_of(solo)),
                  f"{key} scale-12 lane {qi} differs from its solo run")
        counts[f"{key} batched"] = dict(
            steps=got[0], msgs=got[1], bytes=got[2], queries=NQ,
            query_steps=res.query_steps.tolist())
    batch3_s = time.perf_counter() - t_b
    # the composition layer's programs: every count and every channel's
    # bytes exact, each oracle, the S-V variants' labels identical
    t_s = time.perf_counter()
    social = refs["wcc:basic"][0]
    social_pg = pgraph.partition_graph(social, W, "random",
                                       build=REGISTRY["sv:composed"].build)
    pj_spec = REGISTRY["pj:basic"]
    forest = pj_spec.make_graph(12, 0)
    forest_in = pj_spec.inputs(forest, 0)
    forest_pg = pgraph.partition_graph(forest, W, "random",
                                       build=pj_spec.build)
    sv_labels = {}
    for key, want in SV_REFS.items():
        spec = REGISTRY[key]
        graph, pg, inputs = (
            (forest, forest_pg, forest_in) if key.startswith("pj:")
            else (social, social_pg, {}))
        res = eng.run(spec.factory(**inputs), pg)
        got = (res.steps, res.total_msgs, res.total_bytes,
               res.bytes_by_channel)
        check(got == want, f"{key} scale-12 counts {got} != {want}")
        check(res.halted, f"{key} scale-12 did not halt")
        spec.check(graph, pg, res, inputs)
        if key.startswith("sv:"):
            sv_labels[key] = res.output
        counts[key] = dict(steps=got[0], msgs=got[1], bytes=got[2],
                           bytes_by_channel=res.bytes_by_channel)
    for key, labels in sv_labels.items():
        check(np.array_equal(labels, sv_labels["sv:basic"]),
              f"{key} labels differ from sv:basic's at scale 12")
    composed, basic = counts["sv:composed"], counts["sv:basic"]
    check(composed["steps"] < basic["steps"]
          and composed["bytes"] < basic["bytes"],
          "sv:composed does not beat sv:basic on supersteps and bytes at "
          "scale 12")
    sv3_s = time.perf_counter() - t_s
    detail["reference_counts"] = dict(counts, batched_part_s=batch3_s,
                                      composition_part_s=sv3_s)
    print(f"[3/5] scale-12 reference counts exact: " + "; ".join(
        f"{k} {v['steps']}/{v['msgs']}/{v['bytes']}"
        for k, v in counts.items()) +
        f"; all {NQ} lanes of each batched run bit-identical to their solo "
        f"runs; bytes of every channel of the {len(SV_REFS)} composition-"
        f"layer programs exact, their oracles ok, the six S-V variants' "
        f"labels identical, sv:composed ahead of sv:basic "
        f"({composed['steps']} vs {basic['steps']} supersteps, "
        f"{composed['bytes']} vs {basic['bytes']} bytes) "
        f"({time.perf_counter() - t:.1f} s, batched part {batch3_s:.1f} s, "
        f"composition part {sv3_s:.1f} s)", flush=True)

    # -- 4. the main path at full size --------------------------------------
    t = time.perf_counter()
    pr_prog = get_program("pagerank:scatter", iters=30)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    wcc_res, wcc_ms = timed(lambda: eng.run(get_program("wcc:basic"), wcc_pg))
    pr_res, pr_ms = timed(lambda: eng.run(pr_prog, pr_pg))
    launches = ops.launch_counts()
    check(launches["bucket_ranks"] > 0, "wcc:basic never launched bucket_ranks")
    check(launches["segment_combine"] > 0,
          "pagerank:scatter never launched segment_combine")
    pr_again = eng.run(pr_prog, pr_pg)
    check(torch.equal(pr_res.state["pr"], pr_again.state["pr"]),
          "pagerank:scatter ranks differ between two runs on the card")
    t_or = time.perf_counter()
    # the components' ground truth, computed once: wcc:basic, sv:composed,
    # sv:basic and wcc:switch are held to it
    truth = canon(gen.components_ground_truth(wcc_graph))
    check(np.array_equal(canon(wcc_res.output), truth),
          "wcc:basic labels differ from the ground truth")
    REGISTRY["pagerank:scatter"].check(pr_graph, pr_pg, pr_res)
    oracle_s = time.perf_counter() - t_or
    main = {}
    for key, res, pg in (("wcc:basic", wcc_res, wcc_pg),
                         ("pagerank:scatter", pr_res, pr_pg)):
        ms = [1e3 * s for s in res.step_times_s]
        main[key] = dict(n=pg.n, edges=int(
            (wcc_graph if key == "wcc:basic" else pr_graph).num_edges),
            steps=res.steps, halted=res.halted, msgs=res.total_msgs,
            bytes=res.total_bytes, bytes_by_channel=res.bytes_by_channel,
            step_ms=ms, loop_wall_s=res.wall_time_s,
            run_wall_ms=wcc_ms if key == "wcc:basic" else pr_ms,
            route_cap=pg.route_cap)
    detail["main_path"] = dict(main, launches=launches,
                               wcc_host_setup_s=wcc_host_s, oracle_s=oracle_s)

    def fmt_ms(ms):
        return ",".join(f"{x:.2f}" for x in ms)

    print(f"[4/5] main path scale {FULL_SCALE}, W={W}: wcc:basic n="
          f"{wcc_pg.n} {main['wcc:basic']['edges']} edges, "
          f"{wcc_res.steps} steps, {wcc_res.total_bytes} bytes, oracle ok, "
          f"step ms [{fmt_ms(main['wcc:basic']['step_ms'])}]; "
          f"pagerank:scatter {main['pagerank:scatter']['edges']} edges, "
          f"{pr_res.steps} steps, oracle ok (rtol 1e-4, atol 1e-7), two runs "
          f"bit-identical, step ms [{fmt_ms(main['pagerank:scatter']['step_ms'])}]"
          f"; launches {launches} ({time.perf_counter() - t:.1f} s)",
          flush=True)

    # the composed S-V program at full size against the unoptimized one,
    # both on the wcc:basic partition; the inner rounds of the composed
    # program's jump loop are counted through a wrapper of pj_converge
    t = time.perf_counter()
    jump_rounds = []

    def counted_pj_converge(*args, **kw):
        out = pj_converge(*args, **kw)
        jump_rounds.append(out[1])
        return out

    sv_runs = {}
    for key in ("sv:composed", "sv:basic"):
        prog = get_program(key)
        torch.cuda.synchronize()
        base_gib = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        common.pj_converge = counted_pj_converge
        try:
            res, ms = timed(lambda: eng.run(prog, wcc_pg))
        finally:
            common.pj_converge = pj_converge
        sv_runs[key] = dict(
            res=res, run_wall_ms=ms, launches=ops.launch_counts(),
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            base_gib=base_gib)
    sv_launches = sv_runs["sv:composed"]["launches"]
    check(sv_launches["bucket_ranks"] > 0,
          "sv:composed never launched bucket_ranks")
    check(sv_launches["segment_combine"] > 0,
          "sv:composed never launched segment_combine")
    check(len(jump_rounds) == sv_runs["sv:composed"]["res"].steps,
          f"sv:composed ran its jump loop {len(jump_rounds)} times")
    t_or = time.perf_counter()
    for key, run in sv_runs.items():
        res = run["res"]
        check(res.halted and np.array_equal(canon(res.output), truth),
              f"{key} at scale {FULL_SCALE} differs from the ground truth")
    sv_oracle_s = time.perf_counter() - t_or
    composed, basic = sv_runs["sv:composed"]["res"], sv_runs["sv:basic"]["res"]
    check(composed.steps < basic.steps
          and composed.total_bytes < basic.total_bytes,
          f"sv:composed ({composed.steps} supersteps, {composed.total_bytes} "
          f"bytes) does not beat sv:basic ({basic.steps}, "
          f"{basic.total_bytes}) at scale {FULL_SCALE}")
    sv_main = {}
    for key, run in sv_runs.items():
        res = run.pop("res")
        sv_main[key] = dict(
            run, steps=res.steps, msgs=res.total_msgs, bytes=res.total_bytes,
            bytes_by_channel=res.bytes_by_channel,
            bytes_by_group=compose.group_stats(res.bytes_by_channel),
            step_ms=[1e3 * x for x in res.step_times_s],
            loop_wall_s=res.wall_time_s)
    sv_main["sv:composed"]["jump_rounds"] = jump_rounds
    wall_ratio = (sv_main["sv:basic"]["run_wall_ms"]
                  / sv_main["sv:composed"]["run_wall_ms"])

    # wcc:switch on the same partition: wcc:basic's labels and supersteps;
    # pj:reqresp on the scale-20 forest
    sw_res, sw_ms = timed(lambda: eng.run(get_program("wcc:switch"), wcc_pg))
    check(np.array_equal(sw_res.output, wcc_res.output)
          and sw_res.steps == wcc_res.steps,
          "wcc:switch differs from wcc:basic at full size")
    check(np.array_equal(canon(sw_res.output), truth),
          "wcc:switch differs from the ground truth")
    pj_forest = pj_spec.make_graph(FULL_SCALE, 0)
    pj_in = pj_spec.inputs(pj_forest, 0)
    pj_pg = pgraph.partition_graph(pj_forest, W, "random",
                                   build=pj_spec.build)
    pj_res, pj_ms = timed(lambda: eng.run(
        REGISTRY["pj:reqresp"].factory(**pj_in), pj_pg))
    REGISTRY["pj:reqresp"].check(pj_forest, pj_pg, pj_res, pj_in)
    sv_main["wcc:switch"] = dict(
        steps=sw_res.steps, bytes=sw_res.total_bytes,
        bytes_by_channel=sw_res.bytes_by_channel, run_wall_ms=sw_ms,
        step_ms=[1e3 * x for x in sw_res.step_times_s])
    sv_main["pj:reqresp"] = dict(
        n=pj_pg.n, steps=pj_res.steps, bytes=pj_res.total_bytes,
        bytes_by_channel=pj_res.bytes_by_channel, run_wall_ms=pj_ms,
        step_ms=[1e3 * x for x in pj_res.step_times_s])
    detail["sv_path"] = dict(sv_main, composed_launches=sv_launches,
                             wall_ratio_basic_over_composed=wall_ratio,
                             oracle_s=sv_oracle_s,
                             phase_s=time.perf_counter() - t)

    def sv_row(key):
        v = sv_main[key]
        return (f"{key} {v['steps']} steps, {v['bytes']} bytes "
                f"{v['bytes_by_channel']}, step ms [{fmt_ms(v['step_ms'])}], "
                f"run {v['run_wall_ms']:.1f} ms, peak {v['peak_gib']:.2f} GiB "
                f"({v['base_gib']:.2f} before the run)")

    print(f"[4/5] composed S-V scale {FULL_SCALE}, W={W}: "
          f"{sv_row('sv:composed')}, jump rounds a superstep {jump_rounds}; "
          f"{sv_row('sv:basic')}; both oracle ok; sv:composed ahead on "
          f"supersteps and bytes, wall time sv:basic/sv:composed "
          f"{wall_ratio:.2f}x; launches in sv:composed {sv_launches}; "
          f"wcc:switch {sw_res.steps} steps, {sw_res.total_bytes} bytes "
          f"{sw_res.bytes_by_channel}, labels = wcc:basic's, run "
          f"{sw_ms:.1f} ms; pj:reqresp on the {pj_pg.n}-vertex forest "
          f"{pj_res.steps} steps, {pj_res.total_bytes} bytes, oracle ok, run "
          f"{pj_ms:.1f} ms ({time.perf_counter() - t:.1f} s)", flush=True)

    # the batched query plane at full size: Q=32 sources per program.
    # reach's recipe graph is pagerank's (_directed_rmat), so its
    # partition is reused; sssp has its own weighted graph
    t = time.perf_counter()
    check(REGISTRY["reach:basic"].make_graph is
          REGISTRY["pagerank:scatter"].make_graph,
          "reach:basic no longer shares pagerank's recipe graph")
    sssp_spec = REGISTRY["sssp:basic"]
    sssp_graph = sssp_spec.make_graph(FULL_SCALE, 0)
    sssp_pg = pgraph.partition_graph(sssp_graph, W, "random",
                                     build=sssp_spec.build)
    batch_host_s = time.perf_counter() - t
    batch_jobs = {"reach:basic": (pr_graph, pr_pg),
                  "sssp:basic": (sssp_graph, sssp_pg)}
    runs = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    for key, (graph, pg) in batch_jobs.items():
        spec = REGISTRY[key]
        queries = spec.queries(graph, 0, NQ)
        prog = spec.factory()
        res, ms = timed(lambda: eng.run_batch(prog, pg, queries))
        runs[key] = (queries, prog, res, ms)
    b_launches = ops.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(b_launches["bucket_ranks_lanes"] > 0,
          "the batched runs never launched bucket_ranks_lanes")
    batched = {}
    for key, (queries, prog, res, ms) in runs.items():
        spec = REGISTRY[key]
        graph, pg = batch_jobs[key]
        # every lane against its solo run (the serial baseline of the
        # queries/s comparison); the host oracles on the two lanes with
        # the most supersteps (ties: lower lane)
        oracle_lanes = sorted(range(NQ), key=lambda qi: (
            -res.query_steps[qi], qi))[:2]
        solo_ms = []
        for qi, source in enumerate(queries):
            solo, s_ms = timed(lambda: eng.run(spec.factory(source=source),
                                               pg))
            solo_ms.append(s_ms)
            check(same_run(lane_of(res, qi), solo_of(solo)),
                  f"{key} scale-{FULL_SCALE} lane {qi} differs from its "
                  "solo run")
            if qi in oracle_lanes:
                spec.check(graph, pg, solo, {"source": source})
        batched[key] = dict(
            n=pg.n, edges=int(graph.num_edges), e_cap=pg.raw_out.e_cap,
            route_cap=pg.route_cap, steps=res.steps,
            query_steps=res.query_steps.tolist(), msgs=res.total_msgs,
            bytes=res.total_bytes, run_wall_ms=ms,
            step_ms=[1e3 * x for x in res.step_times_s],
            batched_qps=NQ / (ms / 1e3), solo_ms=solo_ms,
            solo_qps=NQ / (sum(solo_ms) / 1e3), oracle_lanes=oracle_lanes)
    batch4_s = time.perf_counter() - t
    detail["batched_path"] = dict(batched, launches=b_launches,
                                  peak_gib=peak_gib,
                                  sssp_host_setup_s=batch_host_s,
                                  phase_s=batch4_s)
    rows = "; ".join(
        f"{k} {v['steps']} steps (lanes {min(v['query_steps'])}-"
        f"{max(v['query_steps'])}), {v['bytes']} bytes, run "
        f"{v['run_wall_ms']:.1f} ms = {v['batched_qps']:.1f} q/s batched vs "
        f"{v['solo_qps']:.1f} q/s solo ({NQ} solo runs, "
        f"{sum(v['solo_ms']):.1f} ms; every lane bit-identical to its solo "
        f"run, oracle ok on lanes {v['oracle_lanes']})"
        for k, v in batched.items())
    print(f"[4/5] batched plane scale {FULL_SCALE}, W={W}, Q={NQ}: {rows}; "
          f"launches {b_launches}; peak device memory {peak_gib:.2f} GiB "
          f"({batch4_s:.1f} s, {batch_host_s:.1f} s of it sssp graph set-up)",
          flush=True)

    # -- 5. times at the scale-20 shapes ------------------------------------
    t = time.perf_counter()
    raw = wcc_pg.raw_out
    n_total = W * wcc_pg.n_loc
    u_dst, _ = routing.dedup_dense(raw.dst_global, raw.mask, n_total)
    # the first superstep's route keys: owner of each unique destination
    rkeys = torch.where(u_dst != routing.BIG, u_dst // wcc_pg.n_loc,
                        W).to(torch.int32)

    def bucket_times(what, fn):
        """Warm and L2-flushed device ms of one call, and the device
        kernels it runs: one launch of the kernel, no fill or memset."""
        per_call = kernels_per_call(fn)
        fills = sum(n for k, (n, _) in per_call.items()
                    if "Memset" in k or "Fill" in k)
        n = sum(n for n, _ in per_call.values())
        check(n - fills == 1 and fills <= 1,
              f"{what}: {n} device kernels per call ({fills} fills): "
              f"{per_call}")
        return dict(ms=cuda_ms(fn), cold_ms=cuda_ms_cold(fn),
                    kernels_per_call=per_call)

    rnd = torch.randint(0, W + 1, rkeys.shape, device=dev, dtype=torch.int32,
                        generator=g)
    b_t = {"sorted": bucket_times("bucket_ranks sorted",
                                  lambda: ops.bucket_ranks(rkeys, W)),
           "random": bucket_times("bucket_ranks random",
                                  lambda: ops.bucket_ranks(rnd, W))}
    b_ms = b_t["sorted"]["ms"]
    b_plain = cuda_ms(lambda: kref.bucket_ranks_ref(rkeys, W), reps=5)
    b_sort = cuda_ms(lambda: torch.sort(rkeys, dim=1, stable=True), reps=10)
    b_bytes = rkeys.numel() * 8 + W * W * 4
    b_bound = 1e3 * b_bytes / HBM_BYTES_PER_S

    l_rnd = torch.randint(0, W + 1, lkeys.shape, device=dev,
                          dtype=torch.int32, generator=g)
    lanes_rnd = ((torch.rand(lanes.shape, device=dev, generator=g) < 0.5)
                 & (l_rnd < W)[..., None])
    l_t = {"sorted": bucket_times(
        "bucket_ranks_lanes sorted",
        lambda: ops.bucket_ranks_lanes(lkeys, lanes, W)),
        "random": bucket_times(
        "bucket_ranks_lanes random",
        lambda: ops.bucket_ranks_lanes(l_rnd, lanes_rnd, W))}
    l_ms = l_t["sorted"]["ms"]
    l_plain = cuda_ms(lambda: kref.bucket_ranks_lanes_ref(lkeys, lanes, W),
                      reps=5)
    l_sort = cuda_ms(lambda: torch.sort(lkeys, dim=1, stable=True), reps=10)
    # key and rank 4 bytes each per entry, the Q membership bytes of each
    # real entry (a sentinel entry's are zero by contract and dropped), and
    # the (B + 1) x (Q + 1) counts per row; beside it the bound that reads
    # every entry's membership (PRs 12-13's reckoning)
    l_real = int((lkeys < W).sum())
    l_counts_bytes = W * (W + 1) * (NQ + 1) * 4
    l_bytes = lkeys.numel() * 8 + l_real * NQ + l_counts_bytes
    l_bytes_all = lkeys.numel() * (8 + NQ) + l_counts_bytes
    l_bound = 1e3 * l_bytes / HBM_BYTES_PER_S
    l_bound_all = 1e3 * l_bytes_all / HBM_BYTES_PER_S

    contrib = torch.rand((W, pr_pg.n_loc, 1), device=dev, generator=g)
    send_vals = contrib.gather(
        1, plan.edge_src.long()[..., None])  # (W, e_cap, 1), as the channel
    recv_vals = torch.rand((W, recv_n, 1), device=dev, generator=g)
    sides = ((send_vals, plan.edge_seg, u_cap),
             (recv_vals, plan.recv_sorted, pr_pg.n_loc))

    def real(s, n):  # entries whose id the kernel must read with a value
        return int(((s >= 0) & (s < n)).sum())

    seg_t = {}
    for side, (v, s, n) in zip(("send", "recv"), sides):
        rows, e, d = v.shape
        out_bytes = rows * n * d * 4
        # one-call yardsticks on a precomputed int64 index of the real
        # entries only, into a preset buffer (the identity fill is not
        # counted). Beside them the same index_add_ with every dropped
        # entry sent to one dump row per worker: a figure of the contention
        # that construction adds, not a yardstick.
        seg64 = s.long()
        keep = (seg64 >= 0) & (seg64 < n)
        idx_all = (torch.where(keep, seg64, n) + torch.arange(
            rows, device=dev)[:, None] * (n + 1)).reshape(-1)
        flat = v.reshape(-1, d)
        idx, real_vals = idx_all[keep.reshape(-1)], flat[keep.reshape(-1)]
        buf = torch.zeros((rows * (n + 1), d), device=dev)
        idx2 = idx[:, None].expand_as(real_vals)
        # torch.segment_reduce over one flat row: N + 1 segments per
        # worker, the last one swallowing the dropped pad entries
        lengths = torch.stack([torch.bincount(r.long(), minlength=n + 1)
                               for r in s]).reshape(-1)
        seg_t[side] = dict(
            shape=list(v.shape), n=n, real_entries=real(s, n),
            ms=cuda_ms(lambda: ops.segment_combine(v, s, n, cb.SUM)),
            cold_ms=cuda_ms_cold(lambda: ops.segment_combine(v, s, n, cb.SUM)),
            min_ms=cuda_ms(lambda: ops.segment_combine(v, s, n, cb.MIN)),
            plain_ms=cuda_ms(lambda: kref.segment_combine_ref(v, s, n, cb.SUM),
                             reps=5),
            index_add_ms=cuda_ms(lambda: buf.index_add_(0, idx, real_vals)),
            scatter_reduce_amin_ms=cuda_ms(lambda: buf.scatter_reduce_(
                0, idx2, real_vals, "amin", include_self=True)),
            dump_row_index_add_ms=cuda_ms(
                lambda: buf.index_add_(0, idx_all, flat)),
            segment_reduce_ms=cuda_ms(lambda: torch.segment_reduce(
                flat, "sum", lengths=lengths, unsafe=True)),
            bytes=real(s, n) * (4 + 4 * d) + out_bytes,
            all_entry_bytes=rows * e * (4 + 4 * d) + out_bytes)
    st = {k: sum(x[k] for x in seg_t.values()) for k in (
        "ms", "cold_ms", "min_ms", "plain_ms", "index_add_ms",
        "scatter_reduce_amin_ms", "dump_row_index_add_ms",
        "segment_reduce_ms", "bytes", "all_entry_bytes")}
    s_ms, s_plain = st["ms"], st["plain_ms"]
    # the same function as the kernel's timed sum, one PyTorch call a side
    s_lib_name, s_lib = min((("index_add_", st["index_add_ms"]),
                             ("segment_reduce", st["segment_reduce_ms"])),
                            key=lambda x: x[1])
    s_bound = 1e3 * st["bytes"] / HBM_BYTES_PER_S
    s_bound_all = 1e3 * st["all_entry_bytes"] / HBM_BYTES_PER_S

    # segment_combine as the S-V neighbour minimum: int32 min per
    # superstep at the sv plan (send: the vertex ids per edge, as the
    # first superstep gathers them; recv: random ids on the wire), beside
    # one scatter_reduce_ amin a side on the real entries into a preset
    # buffer (the identity fill not counted)
    sv_ids = wcc_pg.global_ids()
    sv_sides = (
        (sv_ids.gather(1, sv_plan.edge_src.long())[..., None],
         sv_plan.edge_seg, sv_plan.u_cap),
        (torch.randint(0, W * wcc_pg.n_loc, sv_plan.recv_sorted.shape + (1,),
                       device=dev, dtype=torch.int32, generator=g),
         sv_plan.recv_sorted, wcc_pg.n_loc))
    sv_t = {}
    for side, (v, s, n) in zip(("send", "recv"), sv_sides):
        rows, e, d = v.shape
        seg64 = s.long()
        keep = (seg64 >= 0) & (seg64 < n)
        idx = (seg64 + torch.arange(rows, device=dev)[:, None] * (n + 1))[
            keep]
        real_vals = v.reshape(-1, d)[keep.reshape(-1)]
        buf = torch.full((rows * (n + 1), d), INT32_MAX, dtype=torch.int32,
                         device=dev)
        idx2 = idx[:, None].expand_as(real_vals)
        sv_t[side] = dict(
            shape=list(v.shape), n=n, real_entries=real(s, n),
            ms=cuda_ms(lambda: ops.segment_combine(v, s, n, cb.MIN)),
            cold_ms=cuda_ms_cold(lambda: ops.segment_combine(v, s, n, cb.MIN)),
            plain_ms=cuda_ms(lambda: kref.segment_combine_ref(v, s, n, cb.MIN),
                             reps=5),
            scatter_reduce_amin_ms=cuda_ms(lambda: buf.scatter_reduce_(
                0, idx2, real_vals, "amin", include_self=True)),
            bytes=real(s, n) * (4 + 4 * d) + rows * n * d * 4)
    svs = {k: sum(x[k] for x in sv_t.values()) for k in (
        "ms", "cold_ms", "plain_ms", "scatter_reduce_amin_ms", "bytes")}
    sv_bound = 1e3 * svs["bytes"] / HBM_BYTES_PER_S
    sv_min_entry = dict(
        what=f"int32 min, send + recv at the scale-{FULL_SCALE} S-V plan",
        send_shape=sv_t["send"]["shape"], recv_shape=sv_t["recv"]["shape"],
        launches=sv_launches["segment_combine"], max_abs_err=0.0,
        ms=svs["ms"], cold_ms=svs["cold_ms"], plain_ms=svs["plain_ms"],
        bound_ms=sv_bound, bound_by="bytes",
        library_ms=svs["scatter_reduce_amin_ms"],
        library="scatter_reduce_ amin")
    kernels = [
        dict(name="bucket_ranks", route="cuda",
             source="src/repro_torch/kernels/csrc/bucket_route.cu",
             replaces="src/repro/kernels/bucket_route.py:87",
             launches=launches["bucket_ranks"] + sv_launches["bucket_ranks"],
             launches_by_path=dict(
                 wcc_basic=launches["bucket_ranks"],
                 sv_composed=sv_launches["bucket_ranks"]),
             max_abs_err=errs["bucket_ranks"], ms=b_ms, plain_ms=b_plain,
             bound_ms=b_bound, bound_by="bytes", library_ms=None,
             cold_ms=b_t["sorted"]["cold_ms"], random_ms=b_t["random"]["ms"],
             random_cold_ms=b_t["random"]["cold_ms"]),
        dict(name="segment_combine", route="cuda",
             source="src/repro_torch/kernels/csrc/segment_combine.cu",
             replaces="src/repro/kernels/segment_combine.py:101",
             launches=(launches["segment_combine"]
                       + sv_launches["segment_combine"]),
             launches_by_path=dict(
                 pagerank_scatter=launches["segment_combine"],
                 sv_composed=sv_launches["segment_combine"]),
             max_abs_err=errs["segment_combine"], ms=s_ms, plain_ms=s_plain,
             bound_ms=s_bound, bound_by="bytes", library_ms=s_lib,
             library=s_lib_name, cold_ms=st["cold_ms"],
             all_entry_bound_ms=s_bound_all, int32_min_sv=sv_min_entry),
        dict(name="bucket_ranks_lanes", route="cuda",
             source="src/repro_torch/kernels/csrc/bucket_route.cu",
             replaces="src/repro/kernels/bucket_route.py:128",
             launches=b_launches["bucket_ranks_lanes"],
             max_abs_err=errs["bucket_ranks_lanes"], ms=l_ms,
             plain_ms=l_plain, bound_ms=l_bound, bound_by="bytes",
             library_ms=None, cold_ms=l_t["sorted"]["cold_ms"],
             random_ms=l_t["random"]["ms"],
             random_cold_ms=l_t["random"]["cold_ms"],
             all_entry_bound_ms=l_bound_all),
    ]
    detail["timings"] = dict(
        bucket_ranks=dict(shape=list(rkeys.shape), **b_t, plain_ms=b_plain,
                          stable_sort_ms=b_sort, bytes=b_bytes,
                          bound_ms=b_bound),
        bucket_ranks_lanes=dict(shape=list(lanes.shape), **l_t,
                                plain_ms=l_plain, stable_sort_ms=l_sort,
                                real_entries=l_real, bytes=l_bytes,
                                bound_ms=l_bound, all_entry_bytes=l_bytes_all,
                                all_entry_bound_ms=l_bound_all),
        segment_combine=dict(seg_t, **st, library=s_lib_name,
                             bound_ms=s_bound, all_entry_bound_ms=s_bound_all),
        segment_combine_int32_min_sv=dict(sv_t, **svs, bound_ms=sv_bound))

    def warm_cold(t):
        s, r = t["sorted"], t["random"]
        return (f"sorted {s['ms']:.4f} / {s['cold_ms']:.4f}, random "
                f"{r['ms']:.4f} / {r['cold_ms']:.4f} ms warm / L2 flushed, "
                f"1 device kernel a call")

    print(f"[5/5] times at scale {FULL_SCALE}: bucket_ranks {list(rkeys.shape)}"
          f" {warm_cold(b_t)} (plain {b_plain:.3f}, bound {b_bound:.4f}, "
          f"library none; stable torch.sort {b_sort:.3f}); segment_combine "
          f"per "
          f"superstep (send {list(send_vals.shape)} + recv "
          f"{list(recv_vals.shape)}) {s_ms:.4f} ms warm [send "
          f"{seg_t['send']['ms']:.4f}, recv {seg_t['recv']['ms']:.4f}], "
          f"{st['cold_ms']:.4f} ms L2 flushed [send "
          f"{seg_t['send']['cold_ms']:.4f}, recv "
          f"{seg_t['recv']['cold_ms']:.4f}], min {st['min_ms']:.4f} (plain "
          f"{s_plain:.3f}, bound {s_bound:.4f} on real entries, "
          f"{s_bound_all:.4f} on all e_cap entries; on the real entries "
          f"index_add_ {st['index_add_ms']:.4f}, scatter_reduce_ amin "
          f"{st['scatter_reduce_amin_ms']:.4f}; index_add_ with a dump row "
          f"{st['dump_row_index_add_ms']:.4f}; torch.segment_reduce "
          f"{st['segment_reduce_ms']:.4f}); "
          f"bucket_ranks_lanes {list(lanes.shape)} {warm_cold(l_t)} (plain "
          f"{l_plain:.3f}, bound {l_bound:.4f} reading the membership of the "
          f"{l_real} real entries, {l_bound_all:.4f} of all entries; library "
          f"none; stable torch.sort of the keys {l_sort:.3f}); "
          f"segment_combine int32 min per S-V superstep (send "
          f"{sv_t['send']['shape']} + recv {sv_t['recv']['shape']}) "
          f"{svs['ms']:.4f} ms warm [send {sv_t['send']['ms']:.4f}, recv "
          f"{sv_t['recv']['ms']:.4f}], {svs['cold_ms']:.4f} L2 flushed "
          f"(plain {svs['plain_ms']:.3f}, bound {sv_bound:.4f} on real "
          f"entries, scatter_reduce_ amin on the real entries "
          f"{svs['scatter_reduce_amin_ms']:.4f}) "
          f"({time.perf_counter() - t:.1f} s)", flush=True)

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    s_queries, s_prog, _, s_ms = runs["sssp:basic"]
    detail["profile"] = profile_runs(
        (("wcc:basic", lambda: eng.run(get_program("wcc:basic"), wcc_pg),
          wcc_ms),
         ("pagerank:scatter", lambda: eng.run(pr_prog, pr_pg), pr_ms),
         ("sssp:basic batched", lambda: eng.run_batch(s_prog, sssp_pg,
                                                      s_queries), s_ms),
         ("sv:composed", lambda: eng.run(get_program("sv:composed"), wcc_pg),
          sv_main["sv:composed"]["run_wall_ms"])),
        out_dir)
    print("[5/5] profiled runs: " + "; ".join(
        f"{k}: traced wall {v['wall_ms']:.1f} ms, device "
        f"{v['device_ms']:.1f} ms, busy {v['busy_share']:.2f} (traced run); "
        f"untraced phase-4 wall {v['untraced_wall_ms']:.1f} ms, device/"
        f"untraced {v['busy_vs_untraced']:.2f}; top kernel "
        f"{v['kernels'][0][0][:40]} {v['kernels'][0][1]:.1f} ms"
        for k, v in detail["profile"].items()), flush=True)
    (out_dir / "chip_smoke.json").write_text(
        json.dumps(dict(detail, kernels=kernels), indent=1))
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
