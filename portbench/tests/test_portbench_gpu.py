"""On a CUDA card: each cell's command runs a short window, prints one
result line on the card with ``correct`` true, and a traced run reads its
per-layer metrics. Skips without a card (decided in the fixture)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_on_the_card(card, name, trace):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", name,
                          "--seed", "2147483700", "--seconds", "2", "--trace", str(trace)],
                         capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["failed"] == 0 and r["device"]["platform"] == "gpu"
    cell = harness.load_cell(name, ROOT)
    assert set(r["metrics"]) == {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
