"""Registry runs for ``Engine(backend="dist")`` and the single-process
runs they are held to, bit for bit.

A :class:`Job` names a registry program, its problem scale, the
partition (partitioner, ``mirror_threshold``), a query batch (Q > 0:
``Engine.run_batch`` of the spec's Q queries) and a capacity scale that
starts the run short (``on_overflow="escalate"``). :func:`run_job` runs
one in host mode, locally (every worker in this process) or on a rank of
a group (``worker=rank``), and sums it up in host numpy: outputs, final
state, supersteps, halts, bytes and messages per channel (per lane when
batched), the escalation trail, each kernel's launches, the wall and the
collectives the rank made. :func:`rank_jobs` is the per-rank function
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
import pickle
import time
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


def run_job(job: Job, device, worker: Optional[int] = None,
            problems: Optional[Problems] = None) -> Dict[str, Any]:
    """Run ``job`` in host mode on ``device``: every worker in this
    process (``worker`` None), or worker ``worker`` on a rank of the
    world group. Returns the run's summary in host numpy."""
    problems = Problems() if problems is None else problems
    device = torch.device(device)
    spec, graph, inputs = problems.problem(job)
    pg = pgraph.from_arrays(*problems.tables(job), device=device,
                            worker=worker)
    escalate = job.cap_scale is not None
    eng = Engine(mode="host", device=device,
                 backend="local" if worker is None else "dist",
                 on_overflow="escalate" if escalate else "raise",
                 cap_scales={"*": job.cap_scale} if escalate else None)
    prog = spec.factory(**inputs)
    counted = eng.workers
    before = (counted.collectives, counted.bytes) if counted else (0, 0)
    base = 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    if job.queries:
        res = eng.run_batch(prog, pg, spec.queries(graph, job.seed,
                                                   job.queries))
    else:
        res = eng.run(prog, pg)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    out = {
        "job": job.name,
        "backend": res.backend,
        "output": _host(res.outputs if job.queries else res.output),
        "state": _host(res.state),
        "steps": res.steps,
        "halted": res.halted,
        "bytes": dict(res.bytes_by_channel),
        "msgs": dict(res.msgs_by_channel),
        "recovery": [(ev["attempt"], tuple(ev["channels"]),
                      ev.get("qids"), ev["cap_scales"])
                     for ev in res.recovery or ()],
        "launches": ops.launch_counts(),
        "wall_s": wall,
        "ms_per_step": 1e3 * wall / max(res.steps, 1),
        # the run's own peak, above what the process held before it
        "peak_bytes": (torch.cuda.max_memory_allocated(device) - base
                       if device.type == "cuda" else 0),
        "collectives": (counted.collectives - before[0]) if counted else 0,
        "collective_bytes": (counted.bytes - before[1]) if counted else 0,
    }
    if job.queries:
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
    costs (kernel libraries, the transport's buffers) and lines the ranks
    up, so no job's wall holds a peer's partitioning."""
    problems = Problems()
    for job in jobs:
        problems.tables(job)
    if jobs:
        warm = Job(jobs[0].key, 6, jobs[0].workers)
        run_job(warm, device, worker=rank, problems=problems)
    return [run_job(job, device, worker=rank, problems=problems)
            for job in jobs]


# the fields that hold measurements, not results
TIMES = ("wall_s", "ms_per_step", "peak_bytes", "collectives",
         "collective_bytes", "backend", "job")


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


def default_jobs(scale: int, queries: int = 8, world: int = 4) -> List[Job]:
    """The multi-device set: the JAX mesh test's programs and the
    float-sum ScatterCombine, the mirror-on-mesh set on the ``degree``
    partition (mirrored at 8 and unmirrored), and batched ``sssp:basic``
    and ``pj:reqresp``."""
    jobs = [Job(k, scale, world) for k in
            ("wcc:basic", "sv:composed", "sssp:basic", "pagerank:scatter")]
    for key in ("wcc:switch", "sv:composed", "sssp:basic"):
        for thr in (8, None):
            jobs.append(Job(key, scale, world, partitioner="degree",
                            mirror_threshold=thr))
    jobs += [Job(k, scale, world, queries=queries)
             for k in ("sssp:basic", "pj:reqresp")]
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
