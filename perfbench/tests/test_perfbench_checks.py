"""What decides ``correct``: the control (the reference in the precision
below the configuration's, or with its guarantee broken) fails each
cell's limits, and a run whose timed path is broken underneath comes out
not correct, once for each fault the cell can have."""
import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from perfbench import harness

from conftest import ROOT, small_root

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
CPU = torch.device("cpu")


def _run(root, cell, seed=2**31 + 17):
    return harness.run_cell(harness.manifest(root), cell, seed, 0.2, False,
                            CPU, time.perf_counter(), root=root)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [5, 2**33 + 1])
def test_the_control_fails_the_cells_limits(cell, seed, tmp_path):
    root = small_root(tmp_path, 10)
    _, config, traffic = harness.cell_parts(harness.manifest(root), cell,
                                            root)
    graph = harness.load("generators", config["generator"]).make(
        config, seed, CPU)
    ref = harness.load("references", traffic["reference"])
    query = (graph.src[0].item() if traffic["reference"] == "sssp"
             else None)
    knobs = traffic.get("knobs", {})
    want = ref.reference(graph, query, knobs)
    numbers = ref.compare(graph, ref.control(graph, query, knobs), want)
    assert any(numbers[k] > v for k, v in traffic["limits"].items()), numbers


def _unchanged(prog):
    def step(ctx, gs, state, i):
        _, _, *more = prog.step(ctx, gs, state, i)
        return (state, True, *more)
    return dataclasses.replace(prog, step=step)


def _half_the_lanes(prog):
    def step(ctx, gs, state, i):
        new, *rest = prog.step(ctx, gs, state, i)
        half = {}
        for k, v in new.items():
            if v.dim() >= 3:  # (W, Q, ...): lanes past the middle left out
                q = v.shape[1] // 2
                v = torch.cat([v[:, :q], state[k][:, q:]], dim=1)
            half[k] = v
        return (half, *rest)
    return dataclasses.replace(prog, step=step)


def _altered(prog):
    def extract(pg, state):
        out = np.array(prog.extract(pg, state), copy=True)
        if out.dtype.kind in "iu":
            i = int(np.flatnonzero(out != out[0])[0])
            out[i] = out[0]
        else:
            i = int(np.flatnonzero(np.isfinite(out) & (out > 0))[-1])
            out[i] *= 1.01
        return out
    return dataclasses.replace(prog, extract=extract)


PROGRAM_FAULTS = {"unchanged_state": _unchanged,
                  "half_the_lanes": _half_the_lanes,
                  "answer_altered": _altered}
#: the faults each cell can have (one card: the exchange left out is the
#: one between the logical workers)
FAULTS = {"cc-sv-composed": ["unchanged_state", "exchange_left_out",
                             "answer_altered"],
          "pr-scatter": ["unchanged_state", "exchange_left_out",
                         "answer_altered"],
          "sssp-solo": ["unchanged_state", "exchange_left_out",
                        "answer_altered"],
          "sssp-serve-l32": ["unchanged_state", "half_the_lanes",
                             "exchange_left_out", "answer_altered"]}


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, root8):
    r = _run(root8, cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in FAULTS[c]])
def test_a_broken_timed_path_is_not_correct(cell, fault, root8,
                                            monkeypatch):
    import repro_torch.algorithms as algorithms
    from repro_torch.distributed.workers import LocalWorkers

    if fault == "exchange_left_out":
        monkeypatch.setattr(LocalWorkers, "exchange",
                            lambda self, buf, peer_dim=1: buf.contiguous())
    else:
        real = algorithms.get_program
        monkeypatch.setattr(
            algorithms, "get_program",
            lambda key, **kw: PROGRAM_FAULTS[fault](real(key, **kw)))
    r = _run(root8, cell)
    assert not r["correct"], r["checks"]
