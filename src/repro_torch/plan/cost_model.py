"""The planner's cost model: corpus-fitted curves and calibration probes
(the port of ``repro.plan.cost_model``).

Two evidence sources:

1. **The committed benchmark corpus** (``BENCH_channel_dataplane.json``,
   ``BENCH_routed_batching.json``, ...), the JAX package's CPU timings:
   log-log power-law fits of route cost (sort against bucket, per wire
   message count) and combine cost (plain against kernel, per edge
   count), and the union-against-lane batching prior. Fits from
   committed JSON are deterministic. The corpus's kernel curve is a
   Pallas interpret-mode CPU curve (``kernel_interpret: true``), so it
   predicts the kernel on ``backend == "cpu"`` only; on the card the
   probe is the kernel's only evidence. For the same reason the
   density-switch threshold is fitted on the CPU only.

2. **Calibration probes**: micro-exchanges timed once at the
   fingerprint's cap bucket on the local device, cached on disk under
   ``.repro_torch_plan_cache/`` (``REPRO_TORCH_PLAN_CACHE`` overrides
   it), keyed by :meth:`Fingerprint.cache_key`. The port's fingerprint
   has the JAX one's fields, so on the CPU both give the same key: a
   cache shared with the JAX package (``.repro_plan_cache/``) would hand
   the port the JAX package's timings. On the card the probes decide
   nothing (the planner's card rule), so they run there only when a
   plan is to be explained (``Planner(explain=True)``). There the route
   probe times the ``bucket_ranks`` kernel against the plain
   ``_slots_sort`` and the combine probe the ``segment_combine`` kernel
   against its plain version (``kernels/ref.py``, called directly:
   ``kernels.ops`` refuses it on a CUDA tensor). The probes only
   measure: no run ever takes the plain path on the card. On the CPU
   the port has no kernel, so the
   kernel candidate's measured cost is ``None``. Probes never enter an
   ``Engine`` cache or its ``stats()``, and the wrappers' launch counts
   are put back after them (the kernels' own device counters, which no
   one can reset, do count them).

A decision consumes ``predicted`` (corpus fit) and ``measured`` (probe)
costs per candidate (``repro_torch.plan.planner``); ``python -m
repro_torch plan --explain`` prints both columns.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.plan.features import Fingerprint

CORPUS_FILES = (
    "BENCH_channel_dataplane.json",
    "BENCH_routed_batching.json",
    "BENCH_query_throughput.json",
    "BENCH_serving.json",
)

#: the coarse grid the density-switch threshold snaps to, so small corpus
#: refreshes do not move a plan
THRESHOLD_GRID = (0.02, 0.05, 0.1, 0.15, 0.2, 0.3, 0.5)

PROBE_REPEATS = 3
PROBE_M_MAX = 16384   # route-probe message bound
PROBE_E_MAX = 4096    # combine-probe edge bound


def corpus_dir(start: Optional[pathlib.Path] = None
               ) -> Optional[pathlib.Path]:
    """Locate the committed BENCH corpus: ``REPRO_BENCH_CORPUS``, then
    the working directory and its parents, then this checkout's root."""
    env = os.environ.get("REPRO_BENCH_CORPUS")
    candidates = []
    if env:
        candidates.append(pathlib.Path(env))
    cwd = pathlib.Path(start or ".").resolve()
    candidates.extend([cwd, *cwd.parents])
    candidates.append(pathlib.Path(__file__).resolve().parents[3])
    for cand in candidates:
        if (cand / CORPUS_FILES[0]).is_file():
            return cand
    return None


@dataclasses.dataclass
class PowerFit:
    """A log-log linear fit ``t(x) = exp(b) * x**a`` of (x, seconds)."""

    a: float
    b: float

    @classmethod
    def fit(cls, xs, ts) -> Optional["PowerFit"]:
        xs = np.asarray(xs, float)
        ts = np.asarray(ts, float)
        ok = (xs > 0) & (ts > 0)
        if ok.sum() < 2:
            return None
        a, b = np.polyfit(np.log(xs[ok]), np.log(ts[ok]), 1)
        return cls(a=float(a), b=float(b))

    def predict(self, x: float) -> float:
        return float(np.exp(self.b) * max(x, 1.0) ** self.a)


@dataclasses.dataclass
class Corpus:
    """The fitted curves extracted from the committed artifacts."""

    route_sort: Optional[PowerFit] = None     # seconds vs m_per_worker
    route_bucket: Optional[PowerFit] = None
    combine_ref: Optional[PowerFit] = None    # seconds vs edges
    combine_kernel: Optional[PowerFit] = None
    combine_kernel_interpret: bool = True     # corpus kernel column mode
    union_vs_lane: Optional[float] = None     # geomean speedup prior
    source_dir: Optional[str] = None

    @classmethod
    def load(cls, root: Optional[pathlib.Path] = None) -> "Corpus":
        root = root or corpus_dir()
        if root is None:
            return cls()
        out = cls(source_dir=str(root))
        try:
            data = json.loads(
                (root / "BENCH_channel_dataplane.json").read_text())
            route = list(data.get("route", {}).values())
            out.route_sort = PowerFit.fit(
                [r["m_per_worker"] for r in route],
                [r["sort_s"] for r in route])
            out.route_bucket = PowerFit.fit(
                [r["m_per_worker"] for r in route],
                [r["bucket_s"] for r in route])
            comb = list(data.get("combine", {}).values())
            out.combine_ref = PowerFit.fit(
                [r["edges"] for r in comb], [r["ref_s"] for r in comb])
            out.combine_kernel = PowerFit.fit(
                [r["edges"] for r in comb], [r["kernel_s"] for r in comb])
            out.combine_kernel_interpret = bool(
                comb[0].get("kernel_interpret", True)) if comb else True
        except (OSError, ValueError, KeyError):
            pass
        try:
            data = json.loads(
                (root / "BENCH_routed_batching.json").read_text())
            ratios = [p["union_vs_lane"]
                      for p in data.get("programs", {}).values()
                      if p.get("union_vs_lane", 0) > 0]
            if ratios:
                out.union_vs_lane = float(np.exp(np.mean(np.log(ratios))))
        except (OSError, ValueError, KeyError):
            pass
        return out


# ---------------------------------------------------------------------------
# calibration probes (device-local, disk-cached, engine-invisible)
# ---------------------------------------------------------------------------


def cache_dir() -> pathlib.Path:
    return pathlib.Path(os.environ.get("REPRO_TORCH_PLAN_CACHE",
                                       ".repro_torch_plan_cache"))


def _timed(fn: Callable[[], object], cuda: bool) -> float:
    """Min-of-N wall seconds of ``fn()``, the device synchronized before
    and after each call; the first call is excluded (it may build the
    kernels, ``kernels/build.py``)."""
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    fn()
    sync()
    best = float("inf")
    for _ in range(PROBE_REPEATS):
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def _run_probes(fp: Fingerprint) -> Dict[str, float]:
    """Time the micro-exchanges behind each decision at ``fp``'s scale,
    on the fingerprint's device. Inputs are the JAX probe's (a seeded
    generator), so a probe re-run measures the same computation."""
    from repro_torch.core import routing
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    cuda = fp.backend == "cuda"
    dev = torch.device("cuda" if cuda else "cpu")
    w = max(fp.workers, 2)
    m = int(min(max(fp.m_cap, 256), PROBE_M_MAX))
    e = int(min(max(fp.m_cap, 256), PROBE_E_MAX))
    segs = max(min(fp.n_loc, e // 2), 8)
    rng = np.random.default_rng(12345)
    keys = torch.as_tensor(rng.integers(0, w, size=(1, m)),
                           dtype=torch.int32, device=dev)
    vals = torch.as_tensor(rng.random(e), dtype=torch.float32, device=dev)
    seg_ids = torch.as_tensor(np.sort(rng.integers(0, segs, size=e)),
                              dtype=torch.int32, device=dev)

    before = kops.wrapper_launch_counts()
    try:
        probes = {
            "m_probe": float(m),
            "e_probe": float(e),
            "route_bucket_s": _timed(
                lambda: kops.bucket_ranks(keys, w), cuda),
            "route_sort_s": _timed(
                lambda: routing._slots_sort(keys, w), cuda),
            "combine_ref_s": _timed(
                lambda: kref.segment_combine_ref(vals, seg_ids, segs, "min"),
                cuda),
        }
        if cuda:  # the CPU has no kernel to time
            probes["combine_kernel_s"] = _timed(
                lambda: kops.segment_combine(vals, seg_ids, segs, "min"),
                cuda)
    finally:
        kops.set_wrapper_launch_counts(before)
    return probes


def calibrate(fp: Fingerprint, enable: bool = True) -> Dict[str, float]:
    """Probe timings for ``fp``: from the on-disk cache when warm, else
    measured once and written back. ``enable=False`` skips probing
    (corpus-only planning) and returns ``{}``."""
    if not enable:
        return {}
    path = cache_dir() / f"{fp.cache_key()}.json"
    try:
        cached = json.loads(path.read_text())
        # through from_json: the disk round trip turns the caps tuple
        # into lists
        if Fingerprint.from_json(cached["fingerprint"]) == fp:
            return cached["probes"]
    except (OSError, ValueError, KeyError, TypeError):
        pass
    probes = _run_probes(fp)
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(
            {"fingerprint": fp.to_json(), "probes": probes}, indent=1))
        tmp.replace(path)
    except OSError:  # a read-only checkout: plan uncached, never fail
        pass
    return probes


# ---------------------------------------------------------------------------
# the model: per-decision candidate costs
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CostModel:
    """Candidate costs for each planner decision at one fingerprint."""

    fp: Fingerprint
    corpus: Corpus
    probes: Dict[str, float]

    @classmethod
    def build(cls, fp: Fingerprint, calibrate_probes: bool = True,
              corpus: Optional[Corpus] = None) -> "CostModel":
        return cls(fp=fp, corpus=corpus or Corpus.load(),
                   probes=calibrate(fp, enable=calibrate_probes))

    def route_costs(self) -> Dict[str, Dict[str, Optional[float]]]:
        """Seconds per routed exchange at the fingerprint's cap, for each
        route_impl candidate."""
        m = self.fp.m_cap
        return {
            "bucket": {
                "predicted": (self.corpus.route_bucket.predict(m)
                              if self.corpus.route_bucket else None),
                "measured": self.probes.get("route_bucket_s"),
            },
            "sort": {
                "predicted": (self.corpus.route_sort.predict(m)
                              if self.corpus.route_sort else None),
                "measured": self.probes.get("route_sort_s"),
            },
        }

    def combine_costs(self) -> Dict[str, Dict[str, Optional[float]]]:
        """Seconds per segment combine at the fingerprint's edge cap, for
        each use_kernel candidate. The corpus's kernel curve predicts only
        where the local device matches its mode: an interpret-mode CPU
        curve on ``backend == "cpu"``, never on the card."""
        e = max(v for k, v in self.fp.caps if k.endswith("e_cap")) \
            if self.fp.caps else self.fp.m_cap
        interpret_here = self.fp.backend == "cpu"
        kernel_pred = None
        if (self.corpus.combine_kernel is not None
                and self.corpus.combine_kernel_interpret == interpret_here):
            kernel_pred = self.corpus.combine_kernel.predict(e)
        return {
            "reference": {
                "predicted": (self.corpus.combine_ref.predict(e)
                              if self.corpus.combine_ref else None),
                "measured": self.probes.get("combine_ref_s"),
            },
            "kernel": {
                "predicted": kernel_pred,
                "measured": self.probes.get("combine_kernel_s"),
            },
        }

    def union_prior(self) -> Optional[float]:
        """Corpus geomean of the union-against-lane batched-routing
        speedup."""
        return self.corpus.union_vs_lane

    def dense_threshold(self) -> tuple:
        """The density-switch crossing: the frontier fraction where the
        routed sparse push (route + combine over ``f*m`` live messages)
        stops undercutting the planned dense broadcast (combine over all
        ``m`` edges). Corpus fit only, so probe noise never moves it.
        Returns ``(threshold, reason)``; no corpus gives the knob default
        0.1, and so does a ``"cuda"`` fingerprint: the corpus's curves are
        CPU timings, as in :meth:`combine_costs`."""
        if self.fp.backend != "cpu":
            return 0.1, "no card corpus — knob default"
        route = self.corpus.route_bucket or self.corpus.route_sort
        combine = self.corpus.combine_ref
        m = float(self.fp.m_cap)
        if route is None or combine is None:
            return 0.1, "no corpus curves — knob default"
        dense_cost = combine.predict(m)
        fracs = np.linspace(0.01, 1.0, 200)
        sparse = np.array([route.predict(f * m) + combine.predict(f * m)
                           for f in fracs])
        cheaper = fracs[sparse < dense_cost]
        crossing = float(cheaper.max()) if len(cheaper) else 0.01
        grid = np.asarray(THRESHOLD_GRID)
        thr = float(grid[np.argmin(np.abs(grid - crossing))])
        return thr, (f"sparse push undercuts dense broadcast below "
                     f"frontier fraction ~{crossing:.2f} at m={int(m)} "
                     f"(corpus fit), snapped to grid")
