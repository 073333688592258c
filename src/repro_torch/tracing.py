"""Spans of the port, on one clock.

A recorder keeps host spans and device spans at the layer
boundaries of the port (graph, engine, loop, superstep, inner loop,
channel, kernel, service, query), all on the host's
``time.perf_counter_ns()`` clock: the clock ``Engine.serve`` stamps its
queries with and a benchmark's host clock reads. It is off unless a
``with recording() as rec:`` is open; outside one every site costs one
module-level check (a host span also checks whether a torch.profiler
runs, below), and a loop captured into a CUDA graph holds no stamp.

A span has a name, a start and an end in nanoseconds, its parent span
(the innermost one open when it began; a device span's is the device
span it lies in, else the host span that drained it) and a request id:
the job's index for an ``Engine.run`` (one a run, counted by the
recorder), the ``qid`` for a served query's spans, inherited by the
spans below. Everything is kept in numpy arrays in memory;
:meth:`Recorder.export` hands it over. There is no file writer.

Host spans (:func:`span`) time the host's own work. While a
torch.profiler runs, each is also opened as
``torch.profiler.record_function(name)``, recording or not, so a
profile's host timeline carries the port's span names.

Device spans (:func:`device_span`) time the device's work. On the card a
span is two stamps: one-thread kernels (``kernels/csrc/trace_stamp.cu``)
that write (site, ``%globaltimer``) into a fixed device ring at a slot
an ``atomicAdd`` on a device cursor hands out. A stamp is a kernel node
when a stream captures, so the span lies at any depth of the captured
loop's IF and WHILE bodies, and every replay and every WHILE body run
stamps again. Site names are fixed on the host when a site launches or
is captured. The ring has a fixed size and a fixed address for the life
of the process (captured loops hold its pointer); it is drained
(:func:`drain`) at the end of each ``Engine.run`` and serving session,
after the readback that synchronizes, never between replays; a stamp
that finds it full is dropped and counted. On the CPU the same sites
record host spans.

The device clock is mapped onto the host's: at :func:`recording` entry
and at every drain, ``CALIBRATION_BRACKETS`` stamps are each launched
between two host clock reads and synchronized; the narrowest bracket's
midpoint gives the offset, and offsets are interpolated linearly in
device time between calibrations (``%globaltimer`` drifts from the host
clock). The export reports the residual (how far any bracket's own
stamp maps outside that bracket) and the timer's granularity on the
card (the greatest common divisor of the steps between its reads).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

#: device ring capacity, in stamps (16 bytes each)
RING_STAMPS = 1 << 20
#: bracketed stamps a calibration takes; the narrowest is kept
CALIBRATION_BRACKETS = 20

_now = now = time.perf_counter_ns
_rec: Optional["Recorder"] = None
# inside paused(): device spans record nothing
_paused = False
# name -> id, fixed for the process (captured stamps hold the ids)
_ids: Dict[str, int] = {}
_names: List[str] = []


def name_id(name: str) -> int:
    """The process's id of a span name."""
    i = _ids.get(name)
    if i is None:
        i = _ids[name] = len(_names)
        _names.append(name)
    return i


def active() -> Optional["Recorder"]:
    """The open recorder, or None."""
    return _rec


def _profiling() -> bool:
    return torch.autograd._profiler_enabled()


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = NULL = _Null()


class _Table:
    """Rows of int64 columns, grown by doubling."""

    def __init__(self, cols: Tuple[str, ...], cap: int = 4096):
        self.cols = cols
        self.data = np.zeros((cap, len(cols)), np.int64)
        self.n = 0

    def add(self, row) -> int:
        if self.n == len(self.data):
            self.data = np.concatenate([self.data, np.zeros_like(self.data)])
        self.data[self.n] = row
        self.n += 1
        return self.n - 1

    def extend(self, rows: np.ndarray) -> None:
        need = self.n + len(rows)
        if need > len(self.data):
            grown = np.zeros((max(need, 2 * len(self.data)),
                              len(self.cols)), np.int64)
            grown[:self.n] = self.data[:self.n]
            self.data = grown
        self.data[self.n:need] = rows
        self.n = need

    def col(self, name: str) -> np.ndarray:
        return self.data[:self.n, self.cols.index(name)]


# span kinds
HOST, DEVICE = 0, 1


class _Ring:
    """One device's stamp ring and cursor, and the calibration's own."""

    def __init__(self, device: torch.device):
        from repro_torch.kernels import build

        lib = build.library("trace_stamp")
        self.launch = lib.trace_stamp_launch
        import ctypes

        self.launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_ulonglong, ctypes.c_ulonglong,
                                ctypes.c_void_p]
        self.launch.restype = ctypes.c_int
        self.device = device
        self.ring = torch.zeros(2 * RING_STAMPS, dtype=torch.int64,
                                device=device)
        self.cursor = torch.zeros(1, dtype=torch.int64, device=device)
        self.cal_ring = torch.zeros(2 * CALIBRATION_BRACKETS,
                                    dtype=torch.int64, device=device)
        self.cal_cursor = torch.zeros(1, dtype=torch.int64, device=device)

    def stamp(self, site: int) -> None:
        err = self.launch(self.ring.data_ptr(), self.cursor.data_ptr(),
                          RING_STAMPS, site,
                          torch.cuda.current_stream(self.device).cuda_stream)
        if err:
            raise RuntimeError(f"a trace stamp failed: CUDA error {err}")

    def _cal_stamp(self, stream) -> None:
        err = self.launch(self.cal_ring.data_ptr(),
                          self.cal_cursor.data_ptr(),
                          len(self.cal_ring) // 2, 0, stream.cuda_stream)
        if err:
            raise RuntimeError(f"a trace stamp failed: CUDA error {err}")

    def brackets(self, n: int) -> np.ndarray:
        """``n`` stamps, each launched and synchronized between two host
        clock reads: rows (before, after, device time)."""
        stream = torch.cuda.current_stream(self.device)
        self.cal_cursor.zero_()
        stream.synchronize()
        host = np.zeros((n, 2), np.int64)
        for i in range(n):
            host[i, 0] = _now()
            self._cal_stamp(stream)
            stream.synchronize()
            host[i, 1] = _now()
        dev = self.cal_ring[:2 * n].view(n, 2)[:, 1].cpu().numpy()
        return np.column_stack([host, dev])

    def take(self) -> Tuple[np.ndarray, int]:
        """The stamps since the last take, (n, 2) (site, device time), and
        how many were dropped; empties the ring. Synchronizes."""
        n = int(self.cursor.item())
        kept = min(n, RING_STAMPS)
        rows = self.ring[:2 * kept].view(kept, 2).cpu().numpy()
        self.cursor.zero_()
        return rows, n - kept


_rings: Dict[int, _Ring] = {}


def _ring(device: torch.device) -> _Ring:
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    ring = _rings.get(index)
    if ring is None:
        ring = _rings[index] = _Ring(torch.device("cuda", index))
    return ring


class Recorder:
    """Spans and device stamps of one :func:`recording`."""

    def __init__(self, device=None):
        self.spans = _Table(("name", "start", "end", "parent", "rid",
                             "kind"))
        # drained stamps: site word, device time, request id, drain,
        # host span that drained them
        self.stamps = _Table(("site", "t_dev", "rid", "drain", "owner"))
        # calibration brackets: before, after, device time, calibration
        self.brackets = _Table(("before", "after", "t_dev", "cal"))
        self.stack: List[int] = []
        self.dropped = 0
        self.drains = 0
        self.next_rid = 0
        self.ring: Optional[_Ring] = None
        if device is not None and torch.device(device).type == "cuda":
            self.ring = _ring(torch.device(device))

    # -- host ----------------------------------------------------------------

    def rid(self) -> int:
        """The request id of the innermost open span (-1: none)."""
        return int(self.spans.data[self.stack[-1], 4]) if self.stack else -1

    def open(self, name: str, t: int, rid: Optional[int] = None) -> int:
        parent = self.stack[-1] if self.stack else -1
        if rid is None:
            rid = self.rid()
        i = self.spans.add((name_id(name), t, t, parent, rid, HOST))
        self.stack.append(i)
        return i

    def close(self, i: int, t: int) -> None:
        self.spans.data[i, 2] = t
        if self.stack and self.stack[-1] == i:
            self.stack.pop()
        elif i in self.stack:
            self.stack.remove(i)

    # -- device --------------------------------------------------------------

    def calibrate(self) -> None:
        if self.ring is None:
            return
        rows = self.ring.brackets(CALIBRATION_BRACKETS)
        cal = np.full((len(rows), 1), self.drains, np.int64)
        self.brackets.extend(np.concatenate([rows, cal], axis=1))

    def drain(self) -> None:
        """Move the ring's stamps into the recorder, tagged with the open
        span's request id, then calibrate the clocks again."""
        if self.ring is None:
            return
        rows, dropped = self.ring.take()
        self.dropped += dropped
        if len(rows):
            owner = self.stack[-1] if self.stack else -1
            extra = np.tile(np.array([self.rid(), self.drains, owner],
                                     np.int64), (len(rows), 1))
            self.stamps.extend(np.concatenate([rows, extra], axis=1))
        self.drains += 1
        self.calibrate()

    # -- export --------------------------------------------------------------

    def export(self) -> dict:
        """Everything recorded, as numpy arrays on the host clock (ns):
        ``spans`` (name id, start, end, parent index, rid, device flag),
        ``names`` (id -> name), ``dropped`` (device stamps
        lost to a full ring, plus stamps left unpaired), the clock
        ``calibration`` and the device's ``gaps`` between ``superstep``
        spans, each put down to the innermost host span open at its
        midpoint."""
        host = self.spans.data[:self.spans.n].copy()
        open_ = np.asarray(self.stack, np.int64)
        if len(open_):  # still open at export: end now
            host[open_, 2] = _now()
        brackets = self.brackets.data[:self.brackets.n]
        points, residual = calibration_points(brackets)
        dev, unpaired = device_spans(self.stamps.data[:self.stamps.n],
                                     points, base=len(host))
        spans = np.concatenate([host, dev]) if len(dev) else host
        names = list(_names)
        gaps = superstep_gaps(spans, names)
        return {
            "names": names,
            "spans": {c: spans[:, i] for i, c in enumerate(
                ("name", "start_ns", "end_ns", "parent", "rid"))}
            | {"device": spans[:, 5] == DEVICE},
            "dropped": int(self.dropped + unpaired),
            "stamps": int(self.stamps.n),
            "calibration": {
                "points": points, "residual_ns": residual,
                "brackets": int(self.brackets.n),
                "granularity_ns": granularity(np.concatenate([
                    brackets[:, 2], self.stamps.col("t_dev")]))},
            "gaps": gaps,
        }


def calibration_points(brackets: np.ndarray):
    """(points, residual_ns) of bracket rows (before, after, device time,
    calibration): one (host ns, device ns, half width) point a
    calibration, from its narrowest bracket; the residual is the furthest
    any bracket's own stamp maps outside that bracket."""
    if not len(brackets):
        return np.zeros((0, 3), np.int64), 0.0
    points = []
    for c in np.unique(brackets[:, 3]):
        b = brackets[brackets[:, 3] == c]
        k = np.argmin(b[:, 1] - b[:, 0])
        mid = (b[k, 0] + b[k, 1]) // 2
        points.append((mid, b[k, 2], (b[k, 1] - b[k, 0]) // 2))
    points = np.asarray(points, np.int64)
    mapped = to_host(brackets[:, 2], points)
    out = np.maximum(brackets[:, 0] - mapped, mapped - brackets[:, 1])
    return points, float(max(out.max(), 0))


def granularity(t_dev: np.ndarray) -> int:
    """The device timer's step: the greatest common divisor of the
    positive differences between its reads (0 without two)."""
    d = np.diff(np.sort(np.asarray(t_dev, np.int64)))
    d = d[d > 0]
    return int(np.gcd.reduce(d)) if len(d) else 0


def to_host(t_dev: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Device times mapped onto the host clock: the offset interpolated
    linearly in device time between calibration points, held flat
    beyond the first and the last."""
    t_dev = np.asarray(t_dev, np.int64)
    if not len(points):
        return t_dev
    order = np.argsort(points[:, 1])
    dev_p = points[order, 1]
    off = (points[order, 0] - points[order, 1]).astype(np.float64)
    # in float64 relative to the first point: exact to well under a ns
    base = dev_p[0]
    shift = np.interp((t_dev - base).astype(np.float64),
                      (dev_p - base).astype(np.float64), off)
    return t_dev + np.rint(shift).astype(np.int64)


def pair(sites: np.ndarray):
    """Begin and end stamps paired by nesting: ``sites`` holds 2 x name id
    + 1 for an end. Returns (begin index, end index, parent begin index
    or -1) arrays, and the count of stamps left unpaired (a drop cuts a
    sequence short)."""
    sites = np.asarray(sites, np.int64)
    n = len(sites)
    is_end = (sites & 1).astype(bool)
    depth = np.cumsum(np.where(is_end, -1, 1))
    if n and depth.min() < 0:
        return (np.zeros(0, np.int64),) * 3 + (n,)
    level = np.where(is_end, depth, depth - 1)
    begins, ends, parents = [], [], []
    unpaired = 0
    prev_b = np.zeros(0, np.int64)
    for lv in range(int(level.max()) + 1 if n else 0):
        at = np.flatnonzero(level == lv)
        b, e = at[0::2], at[1::2]
        if len(b) > len(e):
            unpaired += 1
            b = b[:len(e)]
        ok = (~is_end[b] & is_end[e] & ((sites[b] >> 1) == (sites[e] >> 1)))
        unpaired += 2 * int((~ok).sum())
        b, e = b[ok], e[ok]
        if lv == 0 or not len(prev_b):
            p = np.full(len(b), -1, np.int64)
        else:
            k = np.searchsorted(prev_b, b) - 1
            p = np.where(k >= 0, prev_b[np.maximum(k, 0)], -1)
        begins.append(b)
        ends.append(e)
        parents.append(p)
        prev_b = b
    if not begins:
        return (np.zeros(0, np.int64),) * 3 + (unpaired,)
    return (np.concatenate(begins), np.concatenate(ends),
            np.concatenate(parents), unpaired)


def device_spans(stamps: np.ndarray, points: np.ndarray, base: int = 0):
    """Span rows (name, start, end, parent, rid, kind) of drained stamp
    rows (site, device time, rid, drain, owner), each drain paired on its
    own; ``base`` is the index the first row will have, so parents index
    the combined table. Returns (rows, unpaired stamps)."""
    out, unpaired = [], 0
    if not len(stamps):
        return np.zeros((0, 6), np.int64), 0
    t_host = to_host(stamps[:, 1], points)
    cuts = np.flatnonzero(np.diff(stamps[:, 3])) + 1
    at = base
    for lo, hi in zip(np.r_[0, cuts], np.r_[cuts, len(stamps)]):
        b, e, p, u = pair(stamps[lo:hi, 0])
        unpaired += u
        if not len(b):
            continue
        order = np.argsort(b, kind="stable")
        b, e, p = b[order], e[order], p[order]
        row_of = np.full(hi - lo, -1, np.int64)
        row_of[b] = at + np.arange(len(b))
        owner = stamps[lo, 4]
        parent = np.where(p >= 0, row_of[np.maximum(p, 0)], owner)
        rows = np.column_stack([stamps[lo + b, 0] >> 1, t_host[lo + b],
                                t_host[lo + e], parent, stamps[lo + b, 2],
                                np.full(len(b), DEVICE)])
        out.append(rows)
        at += len(b)
    if not out:
        return np.zeros((0, 6), np.int64), unpaired
    return np.concatenate(out).astype(np.int64), unpaired


def attribute(gaps: np.ndarray, host: np.ndarray) -> np.ndarray:
    """For each (start, end) gap, the row index into ``host`` (rows of
    start, end; spans of one thread, so they nest) of the innermost span
    open at the gap's midpoint, or -1: the rule of the benchmark's
    ``attribute_gaps``."""
    out = np.full(len(gaps), -1, np.int64)
    if not len(gaps):
        return out
    order = np.lexsort((-host[:, 1], host[:, 0])) if len(host) else []
    mids = (gaps[:, 0] + gaps[:, 1]) / 2
    stack: List[int] = []
    i = 0
    for g in np.argsort(mids, kind="stable"):
        mid = mids[g]
        while i < len(order) and host[order[i], 0] <= mid:
            j = order[i]
            while stack and host[stack[-1], 1] < host[j, 0]:
                stack.pop()
            stack.append(j)
            i += 1
        while stack and host[stack[-1], 1] < mid:
            stack.pop()
        out[g] = stack[-1] if stack else -1
    return out


def superstep_gaps(spans: np.ndarray, names: List[str]) -> dict:
    """The device's gaps between ``superstep`` spans (merged) and the
    name id of the innermost host span open at each gap's midpoint (-1:
    none)."""
    empty = {"start_ns": np.zeros(0, np.int64),
             "end_ns": np.zeros(0, np.int64), "name": np.zeros(0, np.int64)}
    if "superstep" not in names:
        return empty
    step = (spans[:, 0] == names.index("superstep")) & (spans[:, 5] == DEVICE)
    iv = spans[step][:, 1:3]
    if len(iv) < 2:
        return empty
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    starts, ends = iv[1:, 0], reach[:-1]
    keep = starts > ends
    gaps = np.column_stack([ends[keep], starts[keep]])
    host = spans[spans[:, 5] == HOST]
    who = attribute(gaps, host[:, 1:3])
    return {"start_ns": gaps[:, 0], "end_ns": gaps[:, 1],
            "name": np.where(who >= 0, host[np.maximum(who, 0), 0], -1)}


# -- the sites ----------------------------------------------------------------


class _HostSpan:
    """A host span, also a torch.profiler range while a profiler runs."""

    __slots__ = ("name", "rid", "i", "rf")

    def __init__(self, name: str, rid: Optional[int] = None):
        self.name, self.rid, self.i, self.rf = name, rid, -1, None

    def begin(self, t: Optional[int] = None) -> "_HostSpan":
        rec = _rec
        if rec is not None:
            self.i = rec.open(self.name, _now() if t is None else t,
                              self.rid)
        if _profiling():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def end(self, t: Optional[int] = None) -> None:
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None
        rec = _rec
        if rec is not None and self.i >= 0:
            rec.close(self.i, _now() if t is None else t)
            self.i = -1

    def __enter__(self):
        return self.begin()

    def __exit__(self, *exc):
        self.end()
        return False


def span(name: str, rid: Optional[int] = None):
    """A host span (a ``with``); ``rid`` None inherits the parent's."""
    if _rec is None and not _profiling():
        return _NULL
    return _HostSpan(name, rid)


def host_span(name: str, rid: Optional[int] = None) -> Optional[_HostSpan]:
    """A host span to :meth:`~_HostSpan.begin` and ``end`` at clock reads
    the caller makes, or None when nothing records it."""
    if _rec is None and not _profiling():
        return None
    return _HostSpan(name, rid)


def run_rid() -> Optional[int]:
    """A fresh request id for a job (an ``Engine.run``), when
    recording."""
    rec = _rec
    if rec is None:
        return None
    rec.next_rid += 1
    return rec.next_rid - 1


class _DeviceSpan:
    __slots__ = ("ring", "site")

    def __init__(self, ring: _Ring, name: str):
        self.ring, self.site = ring, 2 * name_id(name)

    def __enter__(self):
        self.ring.stamp(self.site)
        return self

    def __exit__(self, *exc):
        self.ring.stamp(self.site + 1)
        return False


def device_span(name: str, where):
    """A device span (a ``with``) on ``where``, a ``torch.device`` or a
    tensor on it: on a card, stamps on the current stream (captured when
    it captures); elsewhere a host span."""
    rec = _rec
    if rec is None or _paused:
        return _NULL
    device = where.device if isinstance(where, torch.Tensor) else where
    if device.type == "cuda" and rec.ring is not None:
        return _DeviceSpan(rec.ring, name)
    return _HostSpan(name)


@contextlib.contextmanager
def paused():
    """Device spans record nothing inside: a loop's warm-up
    step, which builds the loop and is no superstep of a run."""
    global _paused
    prev, _paused = _paused, True
    try:
        yield
    finally:
        _paused = prev


def drain() -> None:
    """Move the device's stamps into the open recorder (after a readback
    that synchronized); a no-op when nothing records."""
    rec = _rec
    if rec is not None:
        rec.drain()


@contextlib.contextmanager
def recording(device=None):
    """Record spans until the ``with`` ends; yields the
    :class:`Recorder`. ``device`` (None: the current CUDA device, when
    there is one) is where device spans stamp; on the CPU they are host
    spans. Recordings do not nest."""
    global _rec
    if _rec is not None:
        raise RuntimeError("a recording is already open")
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    rec = Recorder(device)
    if rec.ring is not None:
        torch.cuda.synchronize(rec.ring.device)
        rec.ring.take()  # stamps of loops replayed since the last drain
        rec.calibrate()
    _rec = rec
    try:
        yield rec
    finally:
        _rec = None
        if rec.ring is not None:
            torch.cuda.synchronize(rec.ring.device)
            rec.drain()
