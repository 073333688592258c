"""Continuous-batching query service — lane admission at chunk
boundaries: the port of ``repro.pregel.serve``.

``Engine.run_batch`` answers a closed batch: Q queries enter together
and the loop runs until the last one halts. Serving opens the batch: a
fixed number of always-on lanes, and at every chunk (dispatch) boundary
the lanes whose queries voted halt are harvested (output extracted,
per-lane steps and traffic taken from the chunk's stat rows) and refilled
from a :class:`QueryQueue` via ``VertexProgram.query_init``. The union
route of the batched channels picks the new frontiers up by itself:
admission only rewrites the lane's state slice and clears its halted
word, which the next step's live mask reads.

The substrate is the chunked batched loop built once per session shape
(``runtime.BatchedDeviceLoop(serve=True)``: on the card a captured CUDA
graph of K supersteps, each under an IF node, replayed once a dispatch).
Per-lane ages replace the shared step counter, so every tenancy equals a
solo ``Engine.run`` of its query bit for bit: output, step count and
per-channel traffic. Admission and harvest touch the loop's static state
buffers in place between replays, on the stream the replays run on; a
harvested lane's slice is cloned before the next replay.

Time has two axes: the logical clock counts supersteps (deterministic)
and wall time is measured at dispatch boundaries. When every lane is
idle and the next arrival is in the future the clock fast-forwards.

Failure isolation: a lane whose query overflows a channel is quarantined
instead of ending the session (``status="overflow"``, no output, the
lane recycled); :class:`FaultSpec` injects deterministic failures; a
:class:`~repro_torch.distributed.fault_tolerance.StragglerMonitor`
watches each dispatch's wall time.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.distributed.fault_tolerance import StragglerMonitor
from repro_torch.pregel import errors


def poisson_arrivals(n: int, rate: float, seed: int = 0) -> List[int]:
    """``n`` arrival times (in supersteps) of a seeded Poisson process
    with ``rate`` expected arrivals per superstep: cumulative exponential
    gaps, floored to the superstep grid. Deterministic in (n, rate,
    seed), and the same times as the JAX package's."""
    if rate <= 0:
        raise ValueError(f"arrival rate must be positive, got {rate}")
    rng = np.random.default_rng(77 + seed)
    gaps = rng.exponential(scale=1.0 / rate, size=n)
    return np.floor(np.cumsum(gaps)).astype(np.int64).tolist()


@dataclasses.dataclass
class _Entry:
    arrival: int
    qid: int
    query: Any
    # wall timestamp at which the serving loop first saw this arrival due
    # (set once by mark_eligible; queue wait counts toward wall latency)
    wall_eligible_s: Optional[float] = None

    def __lt__(self, other):  # heap order: arrival time, then FIFO
        return (self.arrival, self.qid) < (other.arrival, other.qid)


class QueryQueue:
    """Arrival-ordered query queue for :meth:`Engine.serve`.

    Entries are ``(arrival, query)`` with ``arrival`` in supersteps on
    the session's logical clock; ties admit in push (FIFO) order, so a
    given schedule always maps to the same lane assignment.
    """

    def __init__(self):
        self._heap: List[_Entry] = []
        self._next_qid = 0

    def push(self, query: Any, arrival: int = 0) -> int:
        """Enqueue one query; returns its qid (dense, in push order)."""
        if arrival < 0:
            raise ValueError(f"arrival must be >= 0, got {arrival}")
        qid = self._next_qid
        self._next_qid += 1
        heapq.heappush(self._heap, _Entry(int(arrival), qid, query))
        return qid

    @classmethod
    def from_queries(cls, queries: Iterable[Any]) -> "QueryQueue":
        """All queries arrive at t=0 (the all-at-once schedule)."""
        q = cls()
        for query in queries:
            q.push(query)
        return q

    @classmethod
    def from_schedule(cls, pairs: Iterable[tuple]) -> "QueryQueue":
        """From ``(arrival, query)`` pairs (e.g. ``ProgramSpec.stream``)."""
        q = cls()
        for arrival, query in pairs:
            q.push(query, arrival)
        return q

    def __len__(self) -> int:
        return len(self._heap)

    def peek_query(self) -> Any:
        """The next query to be admitted (state-template source)."""
        return self._heap[0].query

    def next_arrival(self) -> Optional[int]:
        return self._heap[0].arrival if self._heap else None

    def pop_ready(self, now: int) -> Optional[_Entry]:
        """Pop the earliest entry whose arrival has passed, else None."""
        if self._heap and self._heap[0].arrival <= now:
            return heapq.heappop(self._heap)
        return None

    def mark_eligible(self, now: int, wall_s: float) -> None:
        """Stamp the wall time at which due entries became admissible
        (first boundary with ``arrival <= now``) — queue wait is part of
        a query's wall latency even before it lands in a lane."""
        for e in self._heap:
            if e.arrival <= now and e.wall_eligible_s is None:
                e.wall_eligible_s = wall_s


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One deterministic fault injection for a serving session.

    Fires at the first chunk boundary at which query ``qid`` has run at
    least ``at_step`` supersteps *of its own tenancy* (per-query steps,
    not the session clock — the same axis a solo run counts).

    kind="overflow": the lane is treated exactly as if a channel
    reported capacity overflow at that boundary (quarantined or raised
    per ``on_fault``). kind="exhaust": the lane is force-harvested as if
    its step budget ran out (partial output extracted, ``halted=False``,
    ``status="exhausted"``). A fault against a query that halts before
    ``at_step`` never fires.
    """

    qid: int
    at_step: int
    kind: str = "overflow"

    def __post_init__(self):
        if self.kind not in ("overflow", "exhaust"):
            raise ValueError(
                f"unknown fault kind {self.kind!r} "
                "(one of ('overflow', 'exhaust'))")
        if self.at_step < 0:
            raise ValueError(f"at_step must be >= 0, got {self.at_step}")


def as_faults(faults) -> Dict[int, FaultSpec]:
    """Normalize a faults argument — FaultSpec instances or plain
    ``(qid, at_step, kind)`` tuples — into a qid-keyed dict (at most one
    fault per qid; duplicates are rejected, not silently merged)."""
    out: Dict[int, FaultSpec] = {}
    for f in (faults or ()):
        spec = f if isinstance(f, FaultSpec) else FaultSpec(*f)
        if spec.qid in out:
            raise ValueError(f"duplicate fault for qid {spec.qid}")
        out[spec.qid] = spec
    return out


@dataclasses.dataclass
class QueryRecord:
    """One served query: identity, placement, timing, and the per-tenancy
    result/accounting (counts only this occupancy of the lane — never
    inherited from the previous occupant)."""

    qid: int
    query: Any
    lane: int
    arrival: int                 # scheduled arrival (logical clock)
    admitted: int                # boundary at which it entered its lane
    finished: int = -1           # boundary at which it was harvested
    steps: int = 0               # supersteps it actually ran
    halted: bool = False         # False = harvested on the step budget
    output: Any = None
    bytes_by_channel: Dict[str, int] = dataclasses.field(default_factory=dict)
    msgs_by_channel: Dict[str, int] = dataclasses.field(default_factory=dict)
    wall_eligible_s: float = 0.0
    wall_admitted_s: float = 0.0
    wall_finished_s: float = 0.0
    # failure disposition: "ok" (voted halt), "exhausted" (step budget),
    # "overflow" (channel capacity — quarantined, no output)
    status: str = "ok"
    injected: bool = False       # failure came from a FaultSpec drill
    channels: Tuple[str, ...] = ()   # overflowed channels, if any

    @property
    def failed(self) -> bool:
        return self.status == "overflow"

    @property
    def latency_steps(self) -> int:
        """Arrival-to-harvest latency on the logical clock (supersteps,
        including queue wait and chunk-boundary quantization)."""
        return self.finished - self.arrival

    @property
    def latency_wall_s(self) -> float:
        return self.wall_finished_s - self.wall_eligible_s

    @property
    def total_bytes(self) -> int:
        return int(sum(self.bytes_by_channel.values()))

    @property
    def total_msgs(self) -> int:
        return int(sum(self.msgs_by_channel.values()))


@dataclasses.dataclass
class ServeResult:
    """One serving session: per-query records plus session aggregates."""

    program: str
    records: List[QueryRecord]
    num_lanes: int
    chunk_size: int
    max_steps: int
    supersteps: int              # supersteps actually executed
    clock: int                   # final logical clock (incl. idle jumps)
    dispatches: int
    wall_time_s: float
    bytes_by_channel: Dict[str, int]
    msgs_by_channel: Dict[str, int]
    # how the routed channels shared the lanes' route passes
    route_batch: str = ""
    # engine/session stamps (Engine.serve): a miss pays the warm-up step
    # and the capture (compile_time_s)
    cache_hit: bool = False
    compile_time_s: float = 0.0
    engine_compiles: int = 0
    engine_cache_hits: int = 0
    # the Plan the serving loop ran under (repro_torch.plan.Plan; its
    # data-plane knobs only: the serving substrate pins mode and chunk)
    plan: Any = None
    # True only when the chunks were replays of a captured CUDA graph (on
    # a group's ranks the substrate runs uncaptured)
    captured: bool = False
    # dispatch indices whose wall time the StragglerMonitor flagged as
    # outliers (> threshold x rolling median), plus the session median
    straggler_dispatches: List[int] = dataclasses.field(default_factory=list)
    dispatch_median_s: float = 0.0

    @property
    def outputs(self) -> List[Any]:
        return [r.output for r in self.records]

    @property
    def num_queries(self) -> int:
        return len(self.records)

    @property
    def failed_qids(self) -> List[int]:
        """qids quarantined on channel overflow (real or injected)."""
        return [r.qid for r in self.records if r.failed]

    @property
    def num_failed(self) -> int:
        return len(self.failed_qids)

    @property
    def total_bytes(self) -> int:
        return int(sum(self.bytes_by_channel.values()))

    @property
    def total_msgs(self) -> int:
        return int(sum(self.msgs_by_channel.values()))

    @property
    def queries_per_s(self) -> float:
        return self.num_queries / self.wall_time_s if self.wall_time_s else 0.0

    def latency_summary(self) -> Dict[str, float]:
        """p50/p99/mean latency in supersteps (deterministic) and wall
        seconds."""
        if not self.records:
            return {k: 0.0 for k in (
                "p50_steps", "p99_steps", "mean_steps",
                "p50_wall_s", "p99_wall_s", "mean_wall_s")}
        steps = np.array([r.latency_steps for r in self.records], np.float64)
        wall = np.array([r.latency_wall_s for r in self.records], np.float64)
        return {
            "p50_steps": float(np.percentile(steps, 50)),
            "p99_steps": float(np.percentile(steps, 99)),
            "mean_steps": float(steps.mean()),
            "p50_wall_s": float(np.percentile(wall, 50)),
            "p99_wall_s": float(np.percentile(wall, 99)),
            "mean_wall_s": float(wall.mean()),
        }


def as_queue(requests) -> QueryQueue:
    """A QueryQueue passes through; any other iterable is an
    all-at-once batch of plain query values (arrival 0). Build a
    :meth:`QueryQueue.from_schedule` explicitly for timed arrivals."""
    if isinstance(requests, QueryQueue):
        return requests
    return QueryQueue.from_queries(requests)


def serve_loop(loop, prog, pg, state0, queue: QueryQueue,
               faults: Optional[Sequence] = None,
               on_fault: str = "quarantine") -> ServeResult:
    """Drive one serving session over a serving loop
    (``runtime.BatchedDeviceLoop(serve=True)``: its lanes, chunk, step
    budget and overflow check) whose lanes start from ``state0``.

    The boundary protocol, in order: (1) admit — pop due arrivals into
    free lanes, writing ``query_init`` state into the lane's slice of the
    loop's state and clearing its age/halt/overflow words; (2) if every
    lane is idle, fast-forward the clock to the next arrival (or finish);
    (3) dispatch one chunk; (4) account the chunk's per-lane steps and
    traffic to each lane's current occupant; (5) apply due fault
    injections and quarantine overflowed lanes (or raise, per
    ``on_fault``); (6) harvest lanes whose query halted or exhausted its
    step budget. Unoccupied lanes stay marked halted, so they are dead
    end to end: frozen state, zero traffic, out of the union route pass.
    On the card the replays' kernel launches go to ``ops.launch_counts``.

    On a rank of a group the loop's state holds the rank's worker:
    ``query_init`` on the rank's graph writes that worker's rows, and a
    harvest gathers every worker's rows of the lane before ``extract``.
    The lane words every decision reads come from the group's votes, so
    every rank admits, harvests and gathers alike.
    """
    L, max_steps = loop.q, loop.max_steps
    check_overflow = loop.check_overflow
    fault_by_qid = as_faults(faults)
    loop.load(state0)
    age = np.zeros(L, np.int32)
    halted = np.ones(L, bool)          # all lanes start unoccupied
    overflow = np.zeros(L, bool)
    occupant: List[Optional[QueryRecord]] = [None] * L
    records: List[QueryRecord] = []
    sess_bytes: Dict[str, int] = {}
    sess_msgs: Dict[str, int] = {}
    monitor = StragglerMonitor()
    stragglers: List[int] = []
    clock = 0
    executed = 0
    dispatches = 0
    t0 = time.perf_counter()
    now = lambda: time.perf_counter() - t0

    with loop.replays_counted():
        while True:
            queue.mark_eligible(clock, now())
            # --- admission: FIFO by (arrival, qid) into the lowest free
            # lane, on the stream the replays run on
            for lane in range(L):
                if occupant[lane] is not None:
                    continue
                entry = queue.pop_ready(clock)
                if entry is None:
                    break
                qstate = prog.query_init(pg, entry.query)
                for key, v in qstate.items():
                    loop.state[key][:, lane].copy_(v)
                age[lane] = 0
                halted[lane] = False
                overflow[lane] = False
                occupant[lane] = QueryRecord(
                    qid=entry.qid, query=entry.query, lane=lane,
                    arrival=entry.arrival, admitted=clock,
                    wall_eligible_s=(entry.wall_eligible_s
                                     if entry.wall_eligible_s is not None
                                     else now()),
                    wall_admitted_s=now())

            if all(r is None for r in occupant):
                nxt = queue.next_arrival()
                if nxt is None:
                    break               # queue drained, lanes empty: done
                clock = max(clock, nxt)  # idle: jump to the next arrival
                continue

            # --- one chunk: up to chunk_size supersteps, all live lanes
            t_disp = time.perf_counter()
            age, halted, overflow, d_steps, db, dm, dovf = loop.serve_chunk(
                age, halted, overflow)
            if monitor.record(dispatches, time.perf_counter() - t_disp):
                stragglers.append(dispatches)
            dispatches += 1
            steps_run = int(d_steps.max())
            clock += steps_run
            executed += steps_run

            # --- per-tenancy accounting: this chunk's stats belong to the
            # lanes' current occupants (admission only happens at
            # boundaries, so a chunk is never split across tenancies)
            occupied = [l for l in range(L) if occupant[l] is not None]
            for acc, per_lane, delta in (
                    (sess_bytes, "bytes_by_channel", db),
                    (sess_msgs, "msgs_by_channel", dm)):
                for name, row in delta.items():
                    acc[name] = acc.get(name, 0) + int(row.sum())
                    for lane in occupied:
                        d = getattr(occupant[lane], per_lane)
                        d[name] = d.get(name, 0) + int(row[lane])
            for lane in occupied:
                occupant[lane].steps += int(d_steps[lane])

            # --- fault injection: force failures due at this boundary
            for lane in occupied:
                rec = occupant[lane]
                spec = fault_by_qid.get(rec.qid)
                if (spec is not None and spec.kind == "overflow"
                        and not rec.injected and rec.steps >= spec.at_step):
                    overflow[lane] = True
                    rec.injected = True

            # --- quarantine (or raise) lanes that overflowed a channel
            ovf_lanes = [l for l in occupied
                         if overflow[l]
                         and (check_overflow or occupant[l].injected)]
            if ovf_lanes:
                if on_fault == "raise":
                    bad = [occupant[l].qid for l in ovf_lanes]
                    chans = sorted(
                        n for n, row in dovf.items()
                        if any(row[l] for l in ovf_lanes))
                    raise errors.ChannelOverflowError(
                        errors.overflow_message(clock, chans, qids=bad),
                        superstep=clock, channels=chans, qids=bad)
                for lane in ovf_lanes:
                    rec = occupant[lane]
                    rec.status = "overflow"
                    rec.channels = tuple(sorted(
                        n for n, row in dovf.items() if row[lane]))
                    rec.output = None
                    rec.halted = False
                    rec.finished = clock
                    rec.wall_finished_s = now()
                    records.append(rec)
                    occupant[lane] = None
                    halted[lane] = True     # dead until refilled (its
                    overflow[lane] = False  # slice is rewritten then)

            # --- harvest: lanes whose query halted or ran out of budget
            # (or whose FaultSpec exhausts it early)
            for lane in occupied:
                rec = occupant[lane]
                if rec is None:
                    continue              # quarantined above
                spec = fault_by_qid.get(rec.qid)
                force = (spec is not None and spec.kind == "exhaust"
                         and rec.steps >= spec.at_step)
                if not (halted[lane] or age[lane] >= max_steps or force):
                    continue
                # a copy: the next replay writes the lane's buffers
                lane_state = loop.gathered({key: v[:, lane].clone()
                                            for key, v in loop.state.items()})
                rec.output = prog.extract(pg, lane_state)
                rec.halted = bool(halted[lane])
                rec.status = "ok" if rec.halted else "exhausted"
                rec.injected = rec.injected or (force and not rec.halted)
                rec.finished = clock
                rec.wall_finished_s = now()
                records.append(rec)
                occupant[lane] = None
                halted[lane] = True      # the lane is dead until refilled

    records.sort(key=lambda r: r.qid)
    return ServeResult(
        program=prog.name,
        records=records,
        num_lanes=L,
        chunk_size=loop.K,
        max_steps=max_steps,
        supersteps=executed,
        clock=clock,
        dispatches=dispatches,
        wall_time_s=time.perf_counter() - t0,
        bytes_by_channel=sess_bytes,
        msgs_by_channel=sess_msgs,
        straggler_dispatches=stragglers,
        dispatch_median_s=monitor.median,
        captured=loop.cuda_graph is not None,
    )
