"""Registry runs for ``Engine(backend="dist")`` and the single-process
runs they are held to, bit for bit.

A :class:`Job` names a registry program, its problem scale, the
partition (partitioner, ``mirror_threshold``), a query batch (Q > 0:
``Engine.run_batch`` of the spec's Q queries, or with ``lanes`` an
``Engine.serve`` session of them through that many lanes), a capacity
scale that starts the run short (``on_overflow="escalate"``), the
engine's mode and chunk size, a checkpoint interval (the run, then a
resume from its first checkpoint) and the plan policy. :func:`run_job`
runs one locally (every worker in this process) or on a rank of a group
(``worker=rank``), and sums it up in host numpy: outputs, final state,
supersteps, dispatches, halts, bytes and messages per channel (per lane
when batched, per record when served), the escalation trail, the
checkpoints' bytes and the resumed run, the plan's key, each kernel's
launches, whether a captured graph ran, the wall and the collectives the
rank made. :func:`rank_jobs` is the per-rank function
:func:`repro_torch.launch.workers.spawn` runs; :func:`differences` names
every field where two summaries differ.

As a module it runs a job list on W ranks and writes rank 0's summaries
(and whether every rank agreed) to a pickle::

    python -m repro_torch.launch.jobs --out build/dist.pkl \\
        --world 4 --scale 20 [--device cpu] [--transport gloo|nccl]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import shutil
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.algorithms import REGISTRY
from repro_torch.graph import pgraph
from repro_torch.kernels import ops
from repro_torch.pregel.engine import Engine


@dataclasses.dataclass(frozen=True)
class Job:
    key: str
    scale: int
    workers: int = 4
    partitioner: str = "random"
    mirror_threshold: Optional[int] = None
    queries: int = 0
    cap_scale: Optional[float] = None
    seed: int = 0
    # the engine: its mode and chunk size (under plan="auto" the planner
    # picks both), served lanes (0: run or run_batch), the checkpoint
    # interval of a chunked solo run, and the plan policy
    mode: str = "host"
    chunk_size: int = 64
    lanes: int = 0
    checkpoint_every: Optional[int] = None
    plan: str = "manual"

    @property
    def name(self) -> str:
        tags = [self.key, f"s{self.scale}"]
        if self.partitioner != "random":
            tags.append(self.partitioner)
        if self.mirror_threshold is not None:
            tags.append(f"mirror{self.mirror_threshold}")
        if self.queries:
            tags.append(f"Q{self.queries}")
        if self.cap_scale is not None:
            tags.append(f"caps{self.cap_scale:g}")
        if self.plan != "manual":
            tags.append(f"plan-{self.plan}")
        elif self.mode != "host":
            tags.append(self.mode)
        if self.mode == "chunked" and self.plan == "manual":
            tags.append(f"K{self.chunk_size}")
        if self.lanes:
            tags.append(f"L{self.lanes}")
        if self.checkpoint_every is not None:
            tags.append(f"ckpt{self.checkpoint_every}")
        return ":".join(tags)


def _host(x):
    """A result leaf as host numpy (dicts, lists and numbers kept)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_host(v) for v in x]
    return x


class Problems:
    """The graphs and partitions of jobs, each made once: programs that
    share a recipe share a graph, and a partition too when they share
    its plans (a ``mirror_threshold`` changes only scatter and
    propagation plans)."""

    def __init__(self):
        self._graphs: dict = {}
        self._tables: dict = {}

    def problem(self, job: Job):
        """``(spec, graph, inputs)``: the spec's default graph at the
        job's scale and its problem inputs."""
        spec = REGISTRY[job.key]
        key = (spec.make_graph, job.scale, job.seed)
        if key not in self._graphs:
            self._graphs[key] = spec.make_graph(job.scale, job.seed)
        graph = self._graphs[key]
        return spec, graph, spec.inputs(graph, job.seed)

    def tables(self, job: Job):
        """The host half of the job's partition (``partition_tables``)."""
        spec, graph, _ = self.problem(job)
        mirrored = any(p.startswith(("scatter", "prop")) for p in spec.build)
        thr = job.mirror_threshold if mirrored else None
        key = (spec.make_graph, spec.build, job.scale, job.workers,
               job.partitioner, thr, job.seed)
        if key not in self._tables:
            self._tables[key] = pgraph.partition_tables(
                graph, job.workers, job.partitioner, build=spec.build,
                mirror_threshold=thr)
        return self._tables[key]


def _engine(job: Job, device, group: bool) -> Engine:
    """The job's engine: under ``plan="auto"`` the planner picks the mode
    and chunk size, else the job's."""
    escalate = job.cap_scale is not None
    manual = job.plan == "manual"
    return Engine(mode=job.mode if manual else None,
                  chunk_size=job.chunk_size if manual else None,
                  plan=job.plan, device=device,
                  backend="dist" if group else "local",
                  on_overflow="escalate" if escalate else "raise",
                  cap_scales={"*": job.cap_scale} if escalate else None)


def _result(res) -> Dict[str, Any]:
    """A run's outputs and counts in host numpy."""
    return {"output": _host(res.outputs if res.num_queries else res.output),
            "state": _host(res.state), "steps": res.steps,
            "halted": res.halted, "dispatches": res.dispatches,
            "bytes": dict(res.bytes_by_channel),
            "msgs": dict(res.msgs_by_channel)}


def _served(res) -> Dict[str, Any]:
    """A serving session in host numpy: every record's fields that do not
    depend on the wall, and the session's totals."""
    records = [{f: _host(getattr(r, f)) for f in (
        "qid", "query", "lane", "arrival", "admitted", "finished", "steps",
        "halted", "status", "output", "bytes_by_channel", "msgs_by_channel")}
        for r in res.records]
    return {"records": records, "output": [r["output"] for r in records],
            "steps": res.supersteps, "clock": res.clock,
            "dispatches": res.dispatches, "halted": all(
                r.halted for r in res.records),
            "bytes": dict(res.bytes_by_channel),
            "msgs": dict(res.msgs_by_channel)}


def _shared_dir(eng: Engine) -> str:
    """A fresh directory every rank of the engine's group names alike
    (rank 0's, broadcast); a local one locally."""
    if eng.workers is None:
        return tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    mine = (tempfile.mkdtemp(prefix="repro_torch_ckpt_")
            if eng.workers.rank == 0 else None)
    return eng.workers.broadcast(mine)


def _checkpointed(job: Job, eng: Engine, prog, pg) -> tuple:
    """The chunked run with its checkpoints, then a resume from the first
    one: ``(result, {file: bytes}, resumed summary)``. On a group rank 0
    writes the files and every rank reads them back."""
    where = _shared_dir(eng)
    try:
        res = eng.run(prog, pg, checkpoint_every=job.checkpoint_every,
                      checkpoint_dir=where)
        # the run's last collective follows rank 0's last write
        files = {f: Path(where, f).read_bytes()
                 for f in sorted(os.listdir(where))}
        resumed = (eng.run(prog, pg, resume=str(Path(where, min(files))))
                   if files else None)
        if eng.workers is not None:
            eng.workers.dist.barrier(group=eng.workers.group)
    finally:
        if eng.workers is None or eng.workers.rank == 0:
            shutil.rmtree(where, ignore_errors=True)
    return res, files, (None if resumed is None else dict(
        _result(resumed), resumed_from=resumed.resumed_from))


def run_job(job: Job, device, worker: Optional[int] = None,
            problems: Optional[Problems] = None) -> Dict[str, Any]:
    """Run ``job`` on ``device``: every worker in this process (``worker``
    None), or worker ``worker`` on a rank of the world group. Returns the
    run's summary in host numpy."""
    problems = Problems() if problems is None else problems
    device = torch.device(device)
    spec, graph, inputs = problems.problem(job)
    pg = pgraph.from_arrays(*problems.tables(job), device=device,
                            worker=worker)
    eng = _engine(job, device, worker is not None)
    prog = spec.factory(**inputs)
    counted = eng.workers
    before = (counted.collectives, counted.bytes) if counted else (0, 0)
    base = 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    ops.reset_launch_counts()
    extra: Dict[str, Any] = {}
    t0 = time.perf_counter()
    if job.lanes:
        res = eng.serve(prog, pg, spec.queries(graph, job.seed, job.queries),
                        num_lanes=job.lanes, chunk_size=job.chunk_size)
        summary = _served(res)
    elif job.queries:
        res = eng.run_batch(prog, pg, spec.queries(graph, job.seed,
                                                   job.queries))
        summary = _result(res)
    elif job.checkpoint_every is not None:
        res, files, resumed = _checkpointed(job, eng, prog, pg)
        summary = _result(res)
        extra = {"checkpoints": files, "resumed": resumed}
    else:
        res = eng.run(prog, pg)
        summary = _result(res)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    plan = res.plan
    out = {
        "job": job.name,
        "backend": eng.backend,
        **summary,
        **extra,
        # the serving substrate is chunked whatever the engine's mode
        "mode": "chunked" if job.lanes else res.mode,
        "captured": res.captured,
        "plan": (plan.key(), plan.source, None if plan.fingerprint is None
                 else plan.fingerprint.cache_key()),
        "recovery": [(ev["attempt"], tuple(ev["channels"]),
                      ev.get("qids"), ev["cap_scales"])
                     for ev in getattr(res, "recovery", None) or ()],
        "launches": ops.launch_counts(),
        "wall_s": wall,
        # a device loop's warm-up step (and, captured, its capture)
        "compile_s": getattr(res, "compile_time_s", 0.0),
        "ms_per_step": 1e3 * wall / max(summary["steps"], 1),
        # the run's own peak, above what the process held before it
        "peak_bytes": (torch.cuda.max_memory_allocated(device) - base
                       if device.type == "cuda" else 0),
        "collectives": (counted.collectives - before[0]) if counted else 0,
        "collective_bytes": (counted.bytes - before[1]) if counted else 0,
    }
    if job.queries and not job.lanes:
        out.update(
            query_steps=np.asarray(res.query_steps),
            query_halted=np.asarray(res.query_halted),
            query_bytes={k: np.asarray(v) for k, v in
                         res.query_bytes_by_channel.items()},
            query_msgs={k: np.asarray(v) for k, v in
                        res.query_msgs_by_channel.items()},
            pad=(res.pad_steps, res.pad_bytes, res.pad_msgs))
    return out


def check_oracle(job: Job, summary: Dict[str, Any], device,
                 problems: Optional[Problems] = None) -> None:
    """Assert a solo job's output against its spec's host oracle."""
    problems = Problems() if problems is None else problems
    spec, graph, inputs = problems.problem(job)
    if spec.check is None or job.queries:
        return
    pg = pgraph.from_arrays(*problems.tables(job), device=device)
    res = type("Result", (), {})()
    res.output, res.steps, res.halted = (
        summary["output"], summary["steps"], summary["halted"])
    spec.check(graph, pg, res, inputs)


def rank_jobs(rank: int, world: int, device, jobs: List[Job]
              ) -> List[Dict[str, Any]]:
    """The per-rank function of a spawn: every job on this rank's worker
    of the world group, in order. Every partition is built first, then a
    small run of the first job's program pays the process's first-use
    costs (kernel libraries, the transport's buffers, the first device
    loop) and lines the ranks up, so no job's wall holds a peer's
    partitioning."""
    problems = Problems()
    for job in jobs:
        problems.tables(job)
    if jobs:
        warm = dataclasses.replace(jobs[0], scale=6)
        run_job(warm, device, worker=rank, problems=problems)
    return [run_job(job, device, worker=rank, problems=problems)
            for job in jobs]


# the fields that hold measurements or the run's setting, not results
# (a group's device loop runs uncaptured, the local one on the card a
# captured graph)
TIMES = ("wall_s", "compile_s", "ms_per_step", "peak_bytes",
         "collectives", "collective_bytes", "backend", "job", "captured")


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return (a.shape == b.shape and a.dtype == b.dtype
                and a.tobytes() == b.tobytes())
    if isinstance(a, float) and isinstance(b, float):
        return np.float64(a).tobytes() == np.float64(b).tobytes()
    return a == b


def differences(got: Dict[str, Any], want: Dict[str, Any],
                skip=TIMES) -> List[str]:
    """The fields of two summaries that differ (bit for bit for arrays
    and floats), measurements aside."""
    keys = (set(got) | set(want)) - set(skip)
    return sorted(k for k in keys
                  if not _same(got.get(k), want.get(k)))


def resume_from(job: Job, data: bytes, device,
                problems: Optional[Problems] = None) -> Dict[str, Any]:
    """``job`` run locally from the checkpoint whose file holds ``data``
    (one a group wrote, say): the summary of the resumed run as a
    checkpoint job's ``"resumed"`` field gives it."""
    problems = Problems() if problems is None else problems
    spec, _, inputs = problems.problem(job)
    pg = pgraph.from_arrays(*problems.tables(job), device=device)
    with tempfile.TemporaryDirectory() as where:
        path = Path(where, "resume.ckpt")
        path.write_bytes(data)
        res = _engine(job, torch.device(device), False).run(
            spec.factory(**inputs), pg, resume=str(path))
    return dict(_result(res), resumed_from=res.resumed_from)


def default_jobs(scale: int, queries: int = 8, world: int = 4,
                 served: int = 12) -> List[Job]:
    """The multi-device set: the JAX mesh test's three programs in the
    engine's default mode (fused) and the float-sum ScatterCombine in
    host mode; the mirror-on-mesh set on the ``degree`` partition
    (mirrored at 8 and unmirrored, host mode); batched ``sssp:basic``
    chunked at K=4 and batched ``pj:reqresp`` in host mode, Q=``queries``;
    ``reach:basic`` served, ``served`` queries through 4 lanes at chunk 4
    (so lanes are refilled); ``sv:composed`` chunked at K=1 with a
    checkpoint at every boundary (and a resume from the first); and
    ``sv:composed`` under ``plan="auto"``."""
    jobs = [Job(k, scale, world, mode="fused")
            for k in ("wcc:basic", "sv:composed", "sssp:basic")]
    jobs.append(Job("pagerank:scatter", scale, world))
    for key in ("wcc:switch", "sv:composed", "sssp:basic"):
        for thr in (8, None):
            jobs.append(Job(key, scale, world, partitioner="degree",
                            mirror_threshold=thr))
    jobs += [Job("sssp:basic", scale, world, queries=queries,
                 mode="chunked", chunk_size=4),
             Job("pj:reqresp", scale, world, queries=queries),
             Job("reach:basic", scale, world, queries=served, lanes=4,
                 mode="chunked", chunk_size=4),
             Job("sv:composed", scale, world, mode="chunked", chunk_size=1,
                 checkpoint_every=1),
             Job("sv:composed", scale, world, plan="auto")]
    return jobs


def main(argv=None) -> int:
    from repro_torch.launch import workers

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--queries", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--transport", default="gloo",
                    choices=workers.TRANSPORTS)
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--jobs", default=None,
                    help="comma-separated job names to run, a subset of "
                         "the default set (default: all of it)")
    args = ap.parse_args(argv)
    jobs = default_jobs(args.scale, args.queries, args.world)
    if args.jobs:
        names = args.jobs.split(",")
        unknown = set(names) - {j.name for j in jobs}
        if unknown:
            ap.error(f"--jobs: not in the default set: {sorted(unknown)}")
        jobs = [j for j in jobs if j.name in names]
    t0 = time.perf_counter()
    ranks = workers.spawn(rank_jobs, args.world, jobs, device=args.device,
                          backend=args.transport, timeout_s=args.timeout,
                          join_timeout_s=20 * args.timeout)
    seconds = time.perf_counter() - t0
    agree = [[differences(r[i], ranks[0][i]) for i in range(len(jobs))]
             for r in ranks]
    with open(args.out, "wb") as f:
        pickle.dump({"jobs": jobs, "ranks": ranks, "agree": agree,
                     "seconds": seconds, "transport": args.transport,
                     "world": args.world}, f)
    return 0


if __name__ == "__main__":
    # run the module's own copy, so that the jobs pickle (and the ranks
    # import) by its real name, not as __main__
    from repro_torch.launch import jobs

    raise SystemExit(jobs.main())
