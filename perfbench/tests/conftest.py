"""Shared set-up of the harness's CPU tests: ``perfbench`` and the port
importable, and a checkout root whose configurations are cut to a scale a
CPU test holds (the traffic, drivers, references and metrics are the
benchmark's own)."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def small_root(tmp: Path, scale: int = 8) -> Path:
    """``tmp`` as a checkout root: BENCHMARK.json as committed, each
    configuration file with its scale set to ``scale``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["scale"] = scale
        path = tmp / c["file"]
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(cfg))
    return tmp


@pytest.fixture
def root8(tmp_path):
    return small_root(tmp_path, 8)
