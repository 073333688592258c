"""The paper's composition tables on the port: unoptimized against
composed, host against fused.

    python -m repro_torch.paper_tables --scale N [--out F] [--device cpu]

The port's counterpart of ``benchmarks/paper_tables.py`` (paper §V,
Tables IV-VII): for each algorithm, the *unoptimized* (standard-channel,
Pregel-style) program against the *composed* (optimized-channel stack)
program, on the same problem instance and the same five cases and
datasets. Rows record supersteps (global rounds), remote messages,
remote bytes, wall time, ms per superstep and kernel launches (peak
device memory on the card); the composed S-V row also its bytes by stack
component. The S-V pair is the paper's headline: the composed program
must win on BOTH global rounds and traffic bytes, or the run exits
non-zero. Rounds and bytes are machine-independent and
equal the JAX package's; the times are the card's.

Each row is the host mode's, with the JAX table's ``fused`` column as
the row's ``fused`` entry: the same program in the fused mode (the
superstep loop replayed as a CUDA graph), its wall time, ms a superstep,
dispatches, host overhead and capture time, and its rounds, messages and
bytes, which must equal the host run's. Every row has one: the inner
loops of ``sv:composed`` and both MSF variants (pointer jumping to a
fixpoint) run as WHILE nodes of the captured graph.
Each program runs twice in each mode and the second run is reported: the
first pays the one-off costs (kernel build, allocator, CUDA context, the
fused mode's capture). The output (default
``chiprun_out/paper_tables_torch.json``) records the card's name and
power limit and the torch and CUDA versions.
"""
from __future__ import annotations

import argparse
import datetime
import functools
import json
import platform
import subprocess
from pathlib import Path

import torch

from repro_torch.algorithms import REGISTRY
from repro_torch.core import compose
from repro_torch.graph import generators as gen
from repro_torch.graph import pgraph
from repro_torch.kernels import ops as kops
from repro_torch.pregel.engine import Engine

W = 8  # logical workers, as in the paper's 8-node cluster

# (algorithm row label, paper dataset, [(program label, registry key,
# factory knobs)]) — the JAX table's cases. The composed S-V also reports
# per-component bytes.
CASES = (
    ("S-V", "social",
     (("unoptimized", "sv:basic", {}), ("composed", "sv:composed", {}))),
    ("WCC", "social",
     (("unoptimized", "wcc:basic", {}), ("composed", "wcc:switch", {}))),
    ("PR", "web",
     (("unoptimized", "pagerank:basic", {"iters": 10}),
      ("composed", "pagerank:scatter", {"iters": 10}))),
    ("PJ", "tree",
     (("unoptimized", "pj:basic", {}), ("composed", "pj:reqresp", {}))),
    ("MSF", "weighted",
     (("unoptimized", "msf:monolithic", {}),
      ("composed", "msf:channels", {}))),
)
SV_COMPONENTS = ("pointer", "neighbor_min", "merge", "jump")


@functools.lru_cache(maxsize=None)
def dataset(name: str, scale: int) -> gen.EdgeList:
    """The paper-table dataset stand-ins that the cases use, sized by
    ``scale`` (the JAX benchmarks' recipes)."""
    if name == "web":          # directed power-law (Wikipedia/WebUK)
        return gen.rmat(scale, edge_factor=12, seed=1, directed=True)
    if name == "social":       # undirected power-law (Facebook/Twitter)
        return gen.rmat(scale, edge_factor=8, seed=2).symmetrized()
    if name == "weighted":      # weighted power-law (RMAT24-like)
        return gen.rmat(scale, edge_factor=8, seed=4,
                        weighted=True).symmetrized()
    raise ValueError(name)


def instance(spec, name: str, scale: int, device):
    """(graph, pg, inputs) of a row's problem: the dataset stand-ins for
    the graph algorithms (MSF two scales smaller, at least 6), the spec's
    own generator for the forest (PJ)."""
    if name == "tree":
        graph = spec.make_graph(scale, 0)
    else:
        s = max(scale - 2, 6) if spec.algorithm == "msf" else scale
        graph = dataset(name, s)
    pg = pgraph.partition_graph(graph, W, "random", build=spec.build,
                                device=device)
    return graph, pg, spec.inputs(graph, 0)


def _row(algorithm, name, label, res, **extra):
    row = {
        "algorithm": algorithm, "dataset": name, "mode": res.mode,
        "program": label, "variant": res.program,
        "supersteps": res.steps, "messages": res.total_msgs,
        "bytes": res.total_bytes, "wall_time_s": res.wall_time_s,
        "ms_per_superstep": 1e3 * res.wall_time_s / max(res.steps, 1),
        "step_ms": [1e3 * t for t in res.step_times_s],
    }
    row.update(extra)
    print(f"  {algorithm:4s} {label:12s} [{res.mode}] rounds {res.steps:4d}"
          f"  msgs {res.total_msgs:9d}  bytes {res.total_bytes:11d}  wall "
          f"{res.wall_time_s:8.4f}s  ({row['ms_per_superstep']:.3f} ms a "
          f"superstep)", flush=True)
    return row


def _measured(eng, prog, pg, key):
    """The second of two runs of ``prog`` on ``eng``, with the launches
    and (on the card) the peak device memory of that run."""
    on_card = eng.device.type == "cuda"
    first = eng.run(prog, pg)
    kops.reset_launch_counts()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    res = eng.run(prog, pg)
    if ((first.steps, first.bytes_by_channel)
            != (res.steps, res.bytes_by_channel)):
        raise RuntimeError(f"{key}: two runs differ in supersteps or bytes")
    extra = {"launches": kops.launch_counts()}
    if on_card:
        extra["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return first, res, extra


def _fused_entry(host, first, res, extra) -> dict:
    """A row's fused column; its counts must be the host run's."""
    if ((res.steps, res.total_msgs, res.bytes_by_channel)
            != (host.steps, host.total_msgs, host.bytes_by_channel)):
        raise RuntimeError(f"{res.program}: the fused run's supersteps, "
                           "messages or bytes differ from host mode's")
    print(f"  {'':4s} {'':12s} [fused] wall {res.wall_time_s:8.4f}s  "
          f"({1e3 * res.wall_time_s / max(res.steps, 1):.3f} ms a "
          f"superstep, {res.dispatches} dispatches, capture "
          f"{first.compile_time_s:.3f}s)", flush=True)
    return dict(
        extra, supersteps=res.steps, messages=res.total_msgs,
        bytes=res.total_bytes, wall_time_s=res.wall_time_s,
        ms_per_superstep=1e3 * res.wall_time_s / max(res.steps, 1),
        dispatches=res.dispatches, host_overhead_s=res.host_overhead_s,
        compile_time_s=first.compile_time_s, cache_hit=res.cache_hit)


def run(scale: int, device="cuda"):
    """Every case at ``scale``: (rows, headline)."""
    eng = Engine(mode="host", device=device)
    fused = Engine(mode="fused", device=device)
    rows, sv = [], {}
    for algorithm, name, programs in CASES:
        graph, pg, inputs = instance(REGISTRY[programs[0][1]], name, scale,
                                     eng.device)
        for label, key, knobs in programs:
            prog = REGISTRY[key].factory(**inputs, **knobs)
            _, res, extra = _measured(eng, prog, pg, key)
            extra["fused"] = _fused_entry(res,
                                          *_measured(fused, prog, pg, key))
            fused.clear_cache()
            if key == "sv:composed":
                extra["bytes_by_component"] = {
                    k: sum(compose.stats_under(res.bytes_by_channel,
                                               f"sv/{k}").values())
                    for k in SV_COMPONENTS}
            rows.append(_row(algorithm, name, label, res, **extra))
            if algorithm == "S-V":
                sv[label] = res
    basic, comp = sv["unoptimized"], sv["composed"]
    headline = {
        "algorithm": "S-V",
        "unoptimized_supersteps": basic.steps,
        "composed_supersteps": comp.steps,
        "unoptimized_bytes": basic.total_bytes,
        "composed_bytes": comp.total_bytes,
        "round_reduction": basic.steps / max(comp.steps, 1),
        "traffic_reduction": basic.total_bytes / max(comp.total_bytes, 1),
        "wall_time_ratio": basic.wall_time_s / max(comp.wall_time_s, 1e-12),
        "composed_beats_unoptimized_rounds": comp.steps < basic.steps,
        "composed_beats_unoptimized_bytes":
            comp.total_bytes < basic.total_bytes,
    }
    print(f"headline: composed S-V {headline['round_reduction']:.3f}x fewer "
          f"global rounds, {headline['traffic_reduction']:.3f}x less traffic "
          f"than unoptimized")
    return rows, headline


def provenance(device) -> dict:
    """Where and when the numbers were measured: the card's name and
    power limit (``nvidia-smi``), the torch and CUDA versions."""
    out = {"device": str(device), "torch_version": torch.__version__,
           "cuda_version": torch.version.cuda,
           "python_version": platform.python_version(),
           "timestamp_utc": datetime.datetime.now(
               datetime.timezone.utc).isoformat(timespec="seconds")}
    if torch.device(device).type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(0)
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    return out


def run_and_write(scale: int,
                  out_path: str = "chiprun_out/paper_tables_torch.json",
                  device="cuda") -> dict:
    """Run the table, write it to ``out_path``, and raise SystemExit
    unless the composed S-V beats the unoptimized one on rounds and
    bytes."""
    print(f"== Paper composition tables on the port (scale {scale}, W={W}, "
          f"host and fused modes, {device}) ==", flush=True)
    rows, headline = run(scale, device)
    out = {"scale": scale, "workers": W, "rows": rows, "headline": headline,
           "provenance": provenance(device)}
    path = Path(out_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=2))
    print(f"wrote {path}")
    if not (headline["composed_beats_unoptimized_rounds"]
            and headline["composed_beats_unoptimized_bytes"]):
        raise SystemExit(
            "headline regression: composed S-V did not beat the "
            "unoptimized S-V on rounds and bytes")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=12)
    ap.add_argument("--out", default="chiprun_out/paper_tables_torch.json")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    run_and_write(args.scale, args.out, args.device)


if __name__ == "__main__":
    main()
