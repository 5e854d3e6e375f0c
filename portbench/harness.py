"""One run of one cell: set-up, the measured window, the check, the
metrics.

Everything that belongs to a cell is found by name: the workload in
``BENCHMARK.json`` names its configuration and traffic mix,
``configs/<config>.json`` names its circuit (``circuits/<circuit>.py`` on
the program's side, ``reference/<circuit>.py`` for the check), and every
metric is read by ``metrics/<metric>.py``'s ``read(ctx)``, which returns a
number or None (nothing to read: the metric is left out of the line). A
metric split by the cells that report it (``<metric>.<part>``, such as
``idle_share.fresh``) is read by ``metrics/<metric>.py`` unless a file of
its full name exists.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
import traceback
from contextlib import nullcontext
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import List, Optional

from portbench import check, jobs as jobs_mod, roofline, trace_math

ROOT = Path(__file__).resolve().parents[1]
GIB = float(1 << 30)


@dataclass
class Cell:
    name: str
    workload: dict
    cfg: dict
    mix: dict
    #: what drives a job: ``jobs`` itself, or the mix's ``traffic/<entry>.py``
    entry: ModuleType
    reference: ModuleType
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str, root: Path = ROOT, cfg_overrides: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` and its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    matches = [w for w in bench["workloads"] if w["name"] == name]
    if len(matches) != 1:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = matches[0]
    (config,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    cfg = json.loads((root / config["file"]).read_text())
    cfg.update(cfg_overrides or {})
    mix = json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    entry = (load_file(root / "portbench" / "traffic" / f"{mix['entry']}.py",
                       f"portbench_entry_{mix['entry']}") if "entry" in mix else jobs_mod)
    reference = importlib.import_module(f"portbench.reference.{cfg['circuit']}")
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    # a per-layer metric without ``workloads`` serves every cell that reports
    # the end-to-end metric it moves (the benchmark's contract)
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in reported else [])]
    return Cell(name, w, cfg, mix, entry, reference, e2e, per_layer)


def load_file(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    folder = root / "portbench" / "metrics"
    path = folder / f"{name}.py"
    if not path.exists():
        path = folder / f"{name.split('.')[0]}.py"
    return load_file(path, f"portbench_metric_{name}")


def read_metrics(specs: List[dict], ctx) -> dict:
    out = {}
    for m in specs:
        value = metric_reader(m["name"], ctx.root).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


class GcClock:
    """A ``gc.callbacks`` entry: the host seconds and the number of the
    interpreter's garbage collections, by generation, while it is listed."""

    def __init__(self):
        self.seconds = [0.0, 0.0, 0.0]
        self.count = [0, 0, 0]
        self._t0 = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            g = int(info["generation"])
            self.seconds[g] += time.perf_counter() - self._t0
            self.count[g] += 1


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, root: Path = ROOT,
             cfg_overrides: Optional[dict] = None,
             builder_kwargs: Optional[dict] = None) -> dict:
    """Run cell ``name`` once; the result's keys in the contract's order,
    the numbers compared last. ``t_start`` is the process's start on the
    host clock (set-up is measured from it); ``cfg_overrides`` and
    ``builder_kwargs`` let a test run the cell small on the CPU."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(name, root, cfg_overrides)
    cfg, mix = cell.cfg, cell.mix
    traffic = jobs_mod.Traffic(cfg, mix, cell.reference, seed, cell.entry)
    program = jobs_mod.Program(cfg, device, builder_kwargs)
    on_card = program.device.type == "cuda"

    # set-up: the resident circuit, then warm-up jobs of the same shapes
    compiled = traffic.entry.prepare(program, traffic.setup_params) if traffic.resident else None
    for i in range(int(mix.get("warmup_jobs", 1))):
        traffic.run_job(program, traffic.job(i, jobs_mod.WARMUP), compiled)
    program.sync()
    setup_peak = torch.cuda.max_memory_allocated(program.device) if on_card else None
    setup_s = time.perf_counter() - t_start

    # the window: a closed loop of one client for ``seconds``
    if on_card:
        torch.cuda.reset_peak_memory_stats(program.device)
    prof = None
    annotate = lambda _name: nullcontext()  # noqa: E731
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=activities)
        prof.__enter__()
        annotate = record_function
    done: List[jobs_mod.Job] = []
    collector = GcClock()
    gc.callbacks.append(collector)
    window_start = time.perf_counter()
    deadline = window_start + float(seconds)
    while True:
        job = traffic.job(len(done))
        job.start = time.perf_counter()
        try:
            with annotate(trace_math.JOB_SPAN):
                traffic.run_job(program, job, compiled, annotate)
        except Exception:  # a job that raised never answers: count it, go on
            job.error = traceback.format_exc(limit=8)
        job.end = time.perf_counter()
        done.append(job)
        if job.end >= deadline:
            break
    window_s = done[-1].end - window_start
    gc.callbacks.remove(collector)
    if prof is not None:
        program.sync()
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(program.device) if on_card else None

    # the program's state goes before anything else runs on the card
    compiled = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    view = trace_math.view(trace_math.profiler_source(prof)) if prof is not None else None
    prof = None

    failed = [j for j in done if j.error is not None]
    for j in failed[:3]:
        print(f"job {j.index} raised:\n{j.error}", file=sys.stderr, flush=True)
    answered = [j for j in done if j.error is None]
    ctx = SimpleNamespace(cfg=cfg, mix=mix, n=int(cfg["num_qubits"]), jobs=answered,
                          window_s=window_s, setup_s=setup_s, peak_bytes=peak, trace=view,
                          gc=collector, root=root)
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, ctx)

    # the check, once the window has closed and the program's state is gone:
    # a closed form on every answer, the plain reference on the sample
    sample = [j for j in traffic.check_sample(done) if j.error is None]
    worst = check.worst_numbers(cfg, cell.reference, sample, program.device, every=answered)
    correct, checks = check.verdict(cell.reference, worst, len(sample), len(failed))

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(program.device) if on_card else "cpu",
           "count": 1,
           "memory_peak_bytes": max(setup_peak, peak) if on_card else None}
    result = {"correct": bool(correct), "attempted": len(done), "failed": len(failed),
              "metrics": metrics, "device": dev}
    if view is not None:
        dev["busy_s"] = view.busy_s
        dev["window_s"] = view.window_s
        result["breakdown"] = {"device_ops": trace_math.top(view.by_name()),
                               "idle_gaps": trace_math.top(view.idle_gaps())}
    result["card"] = roofline.card() if on_card else None
    result["checks"] = checks
    return result
