"""The readings that the limits of ``correct`` are set from, on the card:
for each seed, one run of the cell's timed path (a short window) judged
by the plain reference, and the control (the reference in the precision
below the configuration's, or with the guarantee broken) judged the same
way on the same answers' queries. One JSON line a seed:

    python3 perfbench/calibrate.py --workload NAME --seeds 1,2,3 \\
        --seconds 2 [--control-seeds 1,2,3]

The benchmark's own runs never run the control.
"""
import json
import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from perfbench import harness  # noqa: E402


def control_numbers(run, ref) -> dict:
    """The control's answers for the queries the run's check sampled,
    judged against the reference."""
    knobs = run.traffic.get("knobs", {})
    worst = {}
    for query in dict.fromkeys(q for q, _ in run.answers):
        got = ref.control(run.graph, query, knobs)
        want = ref.reference(run.graph, query, knobs)
        for name, v in ref.compare(run.graph, got, want).items():
            worst[name] = max(worst.get(name, v), v)
    return worst


def main(argv) -> int:
    import argparse

    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    bench = harness.manifest()
    _, _, traffic = harness.cell_parts(bench, args.workload)
    ref = harness.load("references", traffic["reference"])
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    t0 = T0
    for seed in (int(s) for s in args.seeds.split(",")):
        run, result = harness.execute(
            bench, args.workload, seed, args.seconds, False,
            torch.device("cuda", 0), t0)
        line = {"workload": args.workload, "seed": seed,
                "correct": result["correct"],
                "program": {k: c["value"] for k, c in
                            result["checks"].items()},
                "metrics": {k: m["value"] for k, m in
                            result["metrics"].items()},
                "spans": run.spans, "answers": run.answered,
                "checked": len(run.answers),
                "memory_peak_bytes": result["device"]["memory_peak_bytes"]}
        if seed in controls:
            t = time.perf_counter()
            line["control"] = control_numbers(run, ref)
            line["control_s"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
        del run
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
    bad = harness.forbidden_modules()
    if bad:
        print(f"calibrate: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
