"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

  - ``BENCHMARK.json``'s configuration entry names the configuration's
    file (under ``perfbench/configs/``), and that file names its graph
    generator (``perfbench/generators/<generator>.py``);
  - a cell's traffic is ``perfbench/workloads/<traffic>.json``, which names
    the driver that offers it (``perfbench/drivers/<driver>.py``; the
    driver's docstring lists its own keys), the plain reference that
    judges its answers (``perfbench/references/<reference>.py``), how many
    answers the check samples (``check_sample``; a lane, where the driver
    serves lanes) and the limit of each number the reference compares
    (``limits``);
  - each metric is read by ``perfbench/metrics/<metric name>.py``, whose
    ``read(run)`` returns a number, or None where the run has nothing to
    read; a None leaves the metric out of the line.

The program under test is the PyTorch and CUDA port, ``repro_torch``; the
JAX package beside it is never imported (checked by whole top-level module
names before the line is printed).
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from perfbench import yardstick

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "perfbench"
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (the part before the first
    dot) is one of :data:`FORBIDDEN`, compared whole: ``repro_torch`` is
    not ``repro``."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".", 1)[0] in FORBIDDEN)


def load(kind: str, name: str):
    """The module ``perfbench/<kind>/<name>.py`` (names may hold dots and
    dashes, so it is loaded from its path)."""
    mod_name = f"perfbench.{kind}:{name}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise LookupError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[mod_name]
        raise
    return mod


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metrics_of(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (``trace`` false) or its per-layer
    metrics (``trace`` true)."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if _applies(m, cell)]


def cell_parts(bench: dict, workload: str, root: Path = ROOT):
    """(cell entry, configuration dict, traffic dict) of a cell by name."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise LookupError(f"no workload {workload!r} in BENCHMARK.json; "
                          f"known: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads(
        (BENCH / "workloads" / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


@dataclasses.dataclass
class Run:
    """What one run set up, did and observed; the drivers fill it and the
    metric readers read it. Times are the harness's own host clock
    (``time.perf_counter``) unless a field says it is the program's."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t0: float
    graph: Any = None
    partition_s: Optional[float] = None
    setup_s: Optional[float] = None
    window_start: Optional[float] = None
    window_end: Optional[float] = None
    # one dict a job: start, end, and the program's RunResult counters
    jobs: List[dict] = dataclasses.field(default_factory=list)
    # one dict a session: start, end, and the ServeResult's counters
    sessions: List[dict] = dataclasses.field(default_factory=list)
    # one dict a served query: harness latency, the program's stamps
    queries: List[dict] = dataclasses.field(default_factory=list)
    # stratum -> [(query, output)]: a uniform sample, drawn from the
    # seed, of each stratum's answers in the window (``keep``)
    samples: Dict[Any, List[tuple]] = dataclasses.field(default_factory=dict)
    # stratum -> answers offered to its sample
    offered: Dict[Any, int] = dataclasses.field(default_factory=dict)
    # notes for standard error (e.g. a loop built inside the window)
    notes: List[str] = dataclasses.field(default_factory=list)
    # the traced run's busy window (NVML), its eager pass's profile and
    # the kernels' times
    device_trace: Dict[str, Any] = dataclasses.field(default_factory=dict)
    eager_trace: Dict[str, Any] = dataclasses.field(default_factory=dict)
    kernel_times: Dict[str, dict] = dataclasses.field(default_factory=dict)
    state: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # seconds of the set-up's parts and of the check, by name
    spans: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.window_end - self.window_start

    def root_set(self, index: int) -> list:
        """The ``index``-th set of search roots: the configuration's
        ``roots_per_set`` distinct vertices of nonzero degree (the same
        set for every run, so every run offers the same work) in an order
        drawn from the run's seed. Drivers draw the sets a window may use
        in their set-up (:meth:`draw_root_sets`), so the window draws
        none."""
        sets = self.state.setdefault("root_sets", {})
        if index not in sets:
            gen = load("generators", self.config["generator"])
            roots = gen.roots(self.graph, self.config["roots_per_set"],
                              yardstick.substream(self.config["graph_seed"],
                                                  2, index))
            order = np.random.default_rng(yardstick.substream(
                self.seed, 2, index)).permutation(len(roots))
            sets[index] = [roots[i] for i in order]
        return sets[index]

    @property
    def answers(self) -> List[tuple]:
        """The check's sample, (query, output) pairs, stratum by stratum."""
        return [a for kept in self.samples.values() for a in kept]

    @property
    def answered(self) -> int:
        return sum(self.offered.values())

    def keep(self, query, output, stratum=None) -> None:
        """Offer one answer of the window to the check's sample: for each
        ``stratum`` (a served query's lane; the jobs have one) a reservoir
        of the traffic's ``check_sample`` answers, uniform over that
        stratum's answers and drawn from the seed, so the window holds a
        few outputs, not every one, and a fault of one lane is seen."""
        k = self.traffic["check_sample"]
        rng = self.state.get("sample_rng")
        if rng is None:
            rng = self.state["sample_rng"] = np.random.default_rng(
                yardstick.substream(self.seed, 5))
        kept = self.samples.setdefault(stratum, [])
        n = self.offered.get(stratum, 0)
        if n < k:
            kept.append((query, output))
        else:
            slot = int(rng.integers(0, n + 1))
            if slot < k:
                kept[slot] = (query, output)
        self.offered[stratum] = n + 1

    def draw_root_sets(self, count: int) -> None:
        for i in range(count):
            self.root_set(i)

    def edge_list(self):
        """The generated graph as the port's host edge list."""
        from repro_torch.graph.generators import EdgeList

        g = self.graph
        edges = np.stack([g.src.cpu().numpy(), g.dst.cpu().numpy()], axis=1)
        w = None if g.weight is None else g.weight.cpu().numpy()
        return EdgeList(g.n, edges, w, directed=not g.symmetric,
                        name=self.config["name"])

    def partition(self, build):
        """The port's partition of the graph with the configuration's
        workers and partitioner, timed as ``partition_s``."""
        from repro_torch.graph.pgraph import partition_graph

        t = time.perf_counter()
        el = self.edge_list()
        self.spans["edge_list_s"] = time.perf_counter() - t
        t = time.perf_counter()
        pg = partition_graph(
            el, self.config["workers"], self.config["partitioner"],
            seed=self.config["partition_seed"], build=tuple(build),
            device=self.device)
        self.partition_s = time.perf_counter() - t
        return pg


def judge(run: Run, answers: list, ref) -> Dict[str, float]:
    """The reference's numbers over ``answers``, each the worst over the
    answers; the reference is worked out once a distinct query."""
    want: Dict[Any, Any] = {}
    worst: Dict[str, float] = {}
    knobs = run.traffic.get("knobs", {})
    for query, got in answers:
        if query not in want:
            want[query] = ref.reference(run.graph, query, knobs)
        for name, v in ref.compare(run.graph, got, want[query]).items():
            worst[name] = max(worst.get(name, v), v)
    return worst


def checks_of(numbers: Dict[str, float], limits: Dict[str, float],
              failed: int) -> Dict[str, dict]:
    out = {name: {"value": numbers.get(name), "limit": limits[name]}
           for name in limits}
    out["failed_answers"] = {"value": failed, "limit": 0}
    return out


def passes(checks: Dict[str, dict]) -> bool:
    # a number never read (None) fails
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in checks.values())


def device_info(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device, t0: float, root: Path = ROOT) -> dict:
    """Set up, measure and check one cell; returns the result dict (the
    ``checks`` key last). ``device`` is a torch.device: the card, or the
    CPU for tests of the harness (no device trace there)."""
    return execute(bench, workload, seed, seconds, trace, device, t0,
                   root)[1]


def execute(bench: dict, workload: str, seed: int, seconds: float,
            trace: bool, device, t0: float, root: Path = ROOT):
    """:func:`run_cell`, returning ``(run, result)``."""
    import torch

    cell, config, traffic = cell_parts(bench, workload, root)
    run = Run(cell=cell, config=config, traffic=traffic, seed=seed,
              seconds=seconds, trace=trace, device=device, t0=t0)
    driver = load("drivers", traffic["driver"])
    ref = load("references", traffic["reference"])
    on_card = device.type == "cuda"
    if on_card:
        # the allocator's statistics exist once the device is initialised
        torch.zeros(1, device=device)
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    run.graph = load("generators", config["generator"]).make(
        config, config["graph_seed"], device)
    run.spans["generate_s"] = time.perf_counter() - t
    driver.prepare(run)
    if on_card:
        torch.cuda.synchronize(device)
    run.setup_s = time.perf_counter() - t0
    if trace and on_card:
        from perfbench import trace as tr

        with tr.busy_window(run.device_trace):
            driver.measure(run, seconds)
    else:
        driver.measure(run, seconds)
    dev = device_info(device)
    if trace and on_card:
        t = time.perf_counter()
        with tr.eager_trace(run.eager_trace):
            driver.host_pass(run)
        with tr.kernel_times(dev["kind"]) as kt:
            driver.host_pass(run)
        run.kernel_times = kt
        run.spans["trace_passes_s"] = time.perf_counter() - t
    driver.release(run)
    if on_card:
        torch.cuda.empty_cache()
    failed = sum(q["status"] != "ok" for q in run.queries)
    t = time.perf_counter()
    numbers = judge(run, run.answers, ref)
    run.spans["check_s"] = time.perf_counter() - t
    checks = checks_of(numbers, traffic["limits"], failed)
    metrics = {}
    for m in metrics_of(bench, cell["name"], trace):
        value = load("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": passes(checks),
        "attempted": len(run.queries) or len(run.jobs),
        "failed": failed,
        "metrics": metrics,
        "device": dev,
    }
    if trace and run.device_trace:
        t = run.device_trace
        result["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": run.eager_trace["device_ops"],
                               "idle_gaps": run.eager_trace["idle_gaps"]}
    result["checks"] = checks
    result["_notes"] = run.notes
    result["_spans"] = dict(run.spans, setup_s=run.setup_s,
                            partition_s=run.partition_s)
    return run, result


def parse(argv):
    p = argparse.ArgumentParser(
        prog="perfbench/run.py",
        description="Run one cell of BENCHMARK.json once and print its "
                    "result as the last line of standard output.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    if args.seed < 0:
        print(f"perfbench: --seed must be non-negative, got {args.seed}",
              file=sys.stderr)
        return 2
    bench = manifest()
    cell, _, _ = cell_parts(bench, args.workload)
    import torch

    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch sees {seen}", file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), t0)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for note in result.pop("_notes"):
        print(f"perfbench: {note}", file=sys.stderr)
    print("perfbench: set-up and check parts (s): " + json.dumps(
        result.pop("_spans")), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
