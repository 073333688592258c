"""The command as the check runs it: no result without a card, and on
the card (``-m gpu``) one traced run of a cell, line and all."""
import json
import subprocess
import sys

import pytest

from conftest import ROOT


def _run(*args, timeout=900):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", *args], cwd=ROOT,
        capture_output=True, text=True, timeout=timeout)


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = _run("--workload", "pr-scatter", "--seed", "1", "--seconds", "1")
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "needs 1 CUDA device" in p.stderr


def test_an_unknown_workload_is_refused():
    p = _run("--workload", "no-such-cell", "--seed", "1", "--seconds", "1")
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.gpu
def test_a_traced_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = _run("--workload", "pr-scatter", "--seed", str(2**32 + 9),
             "--seconds", "2", "--trace", "1")
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and list(line)[-1] == "checks"
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert 0 < line["metrics"]["seg_combine_roofline.job"]["value"] <= 100
    assert p.stderr.strip().splitlines()[-1].startswith("check ")
