"""Graph/program fingerprints — the port of ``repro.plan.features``.

A :class:`Fingerprint` is what makes two runs the same problem, and all
the planner's cost model may see: the device (type, name, count), the
partitioned graph's static surface (workers, vertex counts, edges,
degree statistics, the plan caps that enter the tables' shapes), the
program's data-plane family (``channel_class``) and the query-axis
width. The planner memoizes its plans and keys its probe cache by
:meth:`Fingerprint.cache_key`; ``Engine(on_overflow="escalate")`` keys
the capacity scales an escalation learned by it, so a later run of the
same problem starts right-sized. Degree statistics are rounded to one
decimal, as in the JAX package. The fields and their JSON are the JAX
package's, so on the CPU both give the same ``cache_key()``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional, Tuple

import torch

from repro_torch.distributed import workers as workers_lib
from repro_torch.graph.pgraph import PartitionedGraph


@dataclasses.dataclass(frozen=True)
class Fingerprint:
    """One (device, graph, program, Q) problem."""

    backend: str          # the graph's device type: "cuda" or "cpu"
    device_kind: str      # torch.cuda.get_device_name, or "cpu"
    device_count: int
    workers: int          # logical workers W
    n: int                # real vertices
    n_loc: int            # per-worker slot count
    edges: int            # real directed edges (sum of out-degrees)
    avg_degree: float     # edges / n, 1 decimal
    deg_skew: float       # max degree / avg degree, 1 decimal
    caps: Tuple[Tuple[str, int], ...]  # plan slot caps present (sorted)
    m_cap: int            # per-worker routed message bound (max raw e_cap)
    channel_class: str    # "static" | "routed" (ProgramSpec.channel_class)
    num_queries: int      # query-axis width (0 = unbatched)

    def cache_key(self) -> str:
        """Stable content hash of the fingerprint."""
        blob = json.dumps(dataclasses.asdict(self), sort_keys=True)
        return hashlib.sha1(blob.encode()).hexdigest()[:16]

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, data: dict) -> "Fingerprint":
        data = dict(data)
        data["caps"] = tuple((str(k), int(v)) for k, v in data["caps"])
        return cls(**data)


def channel_class_of(prog) -> str:
    """The program's data-plane family: its own ``meta`` hint, else the
    registry's ``channel_class`` for its name, else ``"static"``."""
    meta = getattr(prog, "meta", None) or {}
    if "channel_class" in meta:
        return meta["channel_class"]
    # lazy: the registry imports the engine, which imports this module
    from repro_torch.algorithms import channel_class_of as registry_class

    return registry_class(getattr(prog, "name", ""))


def _plan_caps(pg: PartitionedGraph) -> Tuple[Tuple[str, int], ...]:
    caps = {}
    for field in ("scatter_out", "scatter_in"):
        plan = getattr(pg, field)
        if plan is not None:
            caps[f"{field}.e_cap"] = plan.e_cap
            caps[f"{field}.u_cap"] = plan.u_cap
            caps[f"{field}.slot_cap"] = plan.slot_cap
    for field in ("prop_out", "prop_in"):
        plan = getattr(pg, field)
        if plan is not None:
            caps[f"{field}.ei_cap"] = plan.ei_cap
            caps[f"{field}.cut.e_cap"] = plan.cut.e_cap
            caps[f"{field}.cut.slot_cap"] = plan.cut.slot_cap
    for field in ("raw_out", "raw_in"):
        plan = getattr(pg, field)
        if plan is not None:
            caps[f"{field}.e_cap"] = plan.e_cap
    return tuple(sorted(caps.items()))


def fingerprint(prog, pg: PartitionedGraph, num_queries: int = 0,
                backend: Optional[str] = None,
                workers=None) -> Fingerprint:
    """The fingerprint of running ``prog`` on ``pg`` with Q query lanes.
    Reductions over ``deg_out`` and ``v_mask``, read back in one copy; no
    side effects. ``backend`` overrides the graph's device type
    (``"cuda"``/``"cpu"``) in the fingerprint, as the JAX package's
    override does. On a rank of a group (``workers``, a ``GroupWorkers``:
    ``pg`` holds one worker's rows) the reductions are the whole graph's,
    one ``all_gather`` of every rank's partial sums and maximum, so every
    rank and the local backend fingerprint one problem alike."""
    deg = pg.deg_out.to(torch.int64)
    zero = deg.new_zeros(())
    mine = torch.stack([deg.sum(), pg.v_mask.sum().to(torch.int64),
                        deg.max() if deg.numel() else zero])
    parts = workers_lib.resolve(workers, pg.num_workers).gather_host(
        mine).numpy()
    edges, n = int(parts[:, 0].sum()), int(parts[:, 1].sum())
    max_deg = int(parts[:, 2].max())
    avg = edges / max(n, 1)
    caps = _plan_caps(pg)
    raw_caps = [v for k, v in caps
                if k.startswith("raw_") and k.endswith("e_cap")]
    cuda = pg.device.type == "cuda"
    return Fingerprint(
        backend=backend or pg.device.type,
        device_kind=torch.cuda.get_device_name(pg.device) if cuda else "cpu",
        device_count=torch.cuda.device_count() if cuda else 1,
        workers=pg.num_workers,
        n=n,
        n_loc=pg.n_loc,
        edges=edges,
        avg_degree=round(avg, 1),
        deg_skew=round(max_deg / max(avg, 1e-9), 1),
        caps=caps,
        m_cap=max(raw_caps, default=pg.n_loc),
        channel_class=channel_class_of(prog),
        num_queries=int(num_queries),
    )
