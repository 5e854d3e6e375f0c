"""BENCHMARK.json against the contract's shape, and every cell found by
name: its configuration, traffic mix, circuit, reference and metrics are
files of their own, and new ones dropped into their folders are found
without an edit to an existing file."""

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import harness, jobs

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    reports = {m["name"]: set(m.get("workloads", cells)) for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m.get("workloads", reports[m["moves"]])) <= reports[m["moves"]]
    for w in cells:  # every cell: setup_s, another end-to-end metric, a per-layer one
        assert sum(w in r for r in reports.values()) >= 2 and reports["setup_s"] >= {w}
        assert any(w in m.get("workloads", reports[m["moves"]]) for m in BENCH["per_layer"])
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10


@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_resolves_by_name(name):
    cell = harness.load_cell(name, ROOT)
    assert cell.cfg["name"] == cell.workload["config"]
    jobs.validate_mix(cell.mix, cell.entry)
    assert (ROOT / "portbench" / "circuits" / f"{cell.cfg['circuit']}.py").exists()
    assert set(cell.reference.LIMITS)
    assert "setup_s" in {m["name"] for m in cell.end_to_end} and len(cell.end_to_end) >= 2
    assert cell.per_layer
    assert all(m["moves"] in {e["name"] for e in cell.end_to_end} for m in cell.per_layer)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.metric_reader(m["name"], ROOT).read)


def test_new_files_are_found_without_edits(tmp_path):
    """A copy of the checkout gains a configuration, a mix and a metric as
    new files and one new cell in BENCHMARK.json; the harness finds them."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((ROOT / "portbench" / "configs" / "qft32.json").read_text())
    cfg.update(name="qft30", num_qubits=30)
    (tmp_path / "portbench" / "configs" / "qft30.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "portbench" / "traffic" / "resident_amplitudes.json").read_text())
    mix["amplitudes"] = 64
    (tmp_path / "portbench" / "traffic" / "few_amplitudes.json").write_text(json.dumps(mix))
    (tmp_path / "portbench" / "metrics" / "jobs_seen.py").write_text(
        "def read(ctx):\n    return len(ctx.jobs)\n")
    bench["configs"].append({"name": "qft30", "source": "x", "file": "portbench/configs/qft30.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "qft30.few", "config": "qft30",
                               "traffic": "few_amplitudes", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "jobs_seen", "unit": "jobs", "better": "higher",
                                "bound": 0.01, "source": "host_clock"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("qft30.few", tmp_path)
    assert cell.cfg["num_qubits"] == 30 and cell.mix["amplitudes"] == 64
    assert cell.entry is jobs
    assert "jobs_seen" in {m["name"] for m in cell.end_to_end}
    ctx = type("Ctx", (), {"jobs": [1, 2, 3], "root": tmp_path})()
    assert harness.read_metrics([m for m in cell.end_to_end if m["name"] == "jobs_seen"],
                                ctx) == {"jobs_seen": {"value": 3.0, "unit": "jobs"}}


ENTRY = """
KEYS = ("scale",)


def validate(mix):
    assert mix["scale"] > 0


def prepare(program, params):
    return {"prepared": True}


def run_job(program, job, mix, prepared, timed):
    with timed("run"):
        job.answer = {"amps": [mix["scale"] * job.init], "prepared": prepared}
"""


def test_a_mix_with_an_entry_of_its_own(tmp_path):
    """A mix naming ``entry`` is driven by its ``traffic/<entry>.py`` (a job
    that enters the program another way), found without an edit."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "portbench" / "traffic" / "scaled.py").write_text(ENTRY)
    mix = {"why": "x", "loop": "closed", "clients": 1, "compile": "setup",
           "entry": "scaled", "scale": 3, "warmup_jobs": 1, "check_jobs": None}
    (tmp_path / "portbench" / "traffic" / "scaled_mix.json").write_text(json.dumps(mix))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "qft32.scaled", "config": "qft32",
                               "traffic": "scaled_mix", "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("qft32.scaled", tmp_path)
    assert cell.entry.__file__ == str(tmp_path / "portbench" / "traffic" / "scaled.py")
    traffic = jobs.Traffic(cell.cfg, cell.mix, cell.reference, 5, cell.entry)
    job = traffic.job(0)
    traffic.run_job(None, job, cell.entry.prepare(None, traffic.setup_params))
    assert job.answer == {"amps": [0], "prepared": {"prepared": True}}
    assert "run" in job.spans
    with pytest.raises(ValueError, match="unknown traffic keys"):
        jobs.validate_mix({**mix, "other": 1}, cell.entry)
    with pytest.raises(AssertionError):
        jobs.validate_mix({**mix, "scale": 0}, cell.entry)


def test_run_py_names_no_cell():
    src = "".join((ROOT / "portbench" / f).read_text()
                  for f in ("run.py", "harness.py", "jobs.py", "check.py"))
    for name in WORKLOADS + [c["name"] for c in BENCH["configs"]]:
        assert name not in src


@pytest.mark.parametrize("name", WORKLOADS)
def test_same_seed_same_jobs(name):
    cell = harness.load_cell(name, ROOT)
    big = 2**31 + 987654321
    a = jobs.Traffic(cell.cfg, cell.mix, cell.reference, big)
    b = jobs.Traffic(cell.cfg, cell.mix, cell.reference, big)
    for i in (0, 1, 57):
        ja, jb = a.job(i), b.job(i)
        assert (ja.params, ja.init, ja.gen_seed) == (jb.params, jb.init, jb.gen_seed)
        assert (ja.read is None and jb.read is None) or (ja.read == jb.read).all()
    assert a.job(0).key() != jobs.Traffic(cell.cfg, cell.mix, cell.reference, big + 1).job(0).key()
