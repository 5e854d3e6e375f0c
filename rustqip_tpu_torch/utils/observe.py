"""Observability: circuit stats, per-sweep byte accounting, profiling.

Port of ``rustqip_tpu/utils/observe.py`` (the tracing/metrics subsystem,
SURVEY.md §5 -- absent in the reference beyond ``pipeline_depth``):
gate-count and sweep statistics from the compiled plan, state-traffic
estimates per sweep (2 x 2^n x sizeof(amp) bytes: one read and one write of
the state), profilers and a ``torch.profiler`` trace hook.

Times are the device's: CUDA events on a CUDA circuit, the host clock
(``time.perf_counter``) on a CPU one. Sweep boundaries are the circuit's
own plan (``CompiledCircuit.segments`` and ``plan_sweeps`` with its
admission and kernel policy), so they are what ``run`` executes. The
functions that read a plan take a builder, as the JAX package's do, or a
``CompiledCircuit``.

Kernel sweeps and the row-swap pass update the planes in place, and the
profilers run sweeps repeatedly on the same planes: the state they leave is
for timing, not for results.

The program's spans (``span``, named ``rq.<stage>``) mark its stages in a
``torch.profiler`` trace, on the profiler's clock beside the device's
kernels: ``rq.compile`` (``.lower``, ``.fuse``, ``.sweeps``), ``rq.run``
(``.input``), ``rq.sweep.kernel`` / ``rq.sweep.window`` per window,
``rq.op.<kind>`` per single-op pass (a monomial pass in ``rq.op.monomial``
inside ``rq.op.dense`` or ``rq.op.control``) and ``rq.measure.probs`` /
``.draw`` / ``.collapse``. With no profiler active they cost one flag
check. Its counts (``COUNTS``) are kept whether or not a profiler runs.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

from rustqip_tpu_torch.types import TORCH_REAL, geometry

#: The program's counts, kept whether or not a profiler runs (a reader
#: takes their difference over its window): ``swap_bytes``, the bytes that
#: the permutations of the ``SwapOp`` passes run so far must move
#: (``swap_bytes``), whatever carries them out; ``swap_cross_plain``, the
#: ``SwapOp`` passes on CUDA, with the swap kernels on, whose row-lane pairs
#: ran as plain dense passes because the cross pass does not take them
#: (one such pair alone, or pairs off the top row qubits);
#: ``window_plain``, the plain strip windows run (windows of h >= 1 that
#: the window kernel does not take), and ``window_plain_bytes``, their
#: least bytes (``pass_bytes`` each); ``window_stream_thin``, the kernel
#: windows run on the register path whose trailing row segment is under
#: the tile path's smallest tile (``admission.thin_segment``), which the
#: H100's admission takes only because they hold no tile;
#: ``diag_mag_rounded``, the kernel windows run whose diag steps left out
#: a diagonal's log-magnitude that rounds to 1 in float32
#: (``HopperSmemAdmission.diag_mag_max``);
#: ``monomial_pass``, the monomial passes run (``engine/monomial.py``: an
#: op whose matrix is a permutation with phases, on the kernel or its plain
#: version), and ``monomial_bytes``, their least bytes (each touched
#: amplitude read once and written once on both planes:
#: ``MonomialPlan.least_bytes``);
#: ``circuit_runs``, the runs of a ``CompiledCircuit``.
COUNTS: Counter = Counter()

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A range named ``name`` in the active ``torch.profiler`` trace, for
    the host work inside it and the device work it launches; with no
    profiler active, one shared null context (a flag check: no allocation,
    no dispatcher call)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


def swap_bytes(n: int, op, itemsize: int) -> int:
    """Bytes that the permutation of ``op`` (a ``SwapOp`` of k disjoint
    qubit pairs) must move on the (re, im) planes of a 2^n state: the
    2^n - 2^(n-k) amplitudes whose index changes, each read once and
    written once on both planes."""
    return ((1 << n) - (1 << (n - op.half))) * 2 * itemsize * 2


def pass_bytes(n: int, itemsize: int) -> int:
    """Bytes of one pass over a 2^n state's (re, im) planes: every
    amplitude read once and written once on both planes, the least that
    a window over the whole state moves."""
    return (1 << n) * 2 * itemsize * 2


@dataclass
class CircuitStats:
    """Static circuit statistics (pre- and post-compilation)."""

    n_qubits: int
    pipeline_depth: int
    unrolled_gates: int
    measurements: int
    gate_counts: Dict[str, int] = field(default_factory=dict)
    fused_passes: Optional[int] = None
    bytes_per_pass: Optional[int] = None
    est_hbm_traffic_bytes: Optional[int] = None

    def __str__(self) -> str:
        lines = [
            f"qubits: {self.n_qubits}",
            f"pipeline depth: {self.pipeline_depth} "
            f"({self.unrolled_gates} unrolled gates, "
            f"{self.measurements} measurements)",
            f"gate counts: {self.gate_counts}",
        ]
        if self.fused_passes is not None:
            lines.append(
                f"fused passes: {self.fused_passes} "
                f"(~{self.est_hbm_traffic_bytes / 1e9:.2f} GB HBM traffic)"
            )
        return "\n".join(lines)


def circuit_stats(builder, compiled: bool = True) -> CircuitStats:
    """Gate-count / sweep / byte statistics for a builder's circuit."""
    from rustqip_tpu_torch.builder.circuit_objects import (
        MeasurementObject,
        flatten_pipeline,
    )

    flat = flatten_pipeline(builder.pipeline)
    counts: Dict[str, int] = {}
    measurements = 0
    for _, co in flat:
        if isinstance(co.obj, MeasurementObject):
            measurements += 1
            continue
        kind = type(co.obj).__name__
        name = getattr(co.obj, "name", None)
        key = name if name else kind
        counts[key] = counts.get(key, 0) + 1
    stats = CircuitStats(
        n_qubits=builder.n,
        pipeline_depth=builder.pipeline_depth(),
        unrolled_gates=len(flat) - measurements,
        measurements=measurements,
        gate_counts=counts,
    )
    if compiled:
        cc = builder.compile()
        stats.fused_passes = cc.num_sweeps
        stats.bytes_per_pass = _sweep_bytes(cc)
        stats.est_hbm_traffic_bytes = stats.fused_passes * stats.bytes_per_pass
    return stats


def _compiled(circuit):
    """The ``CompiledCircuit`` of a builder, or the circuit itself."""
    return circuit.compile() if hasattr(circuit, "compile") else circuit


def _sweep_bytes(cc) -> int:
    """Bytes one sweep moves: the state read once and written once."""
    return pass_bytes(cc.n, np.dtype(cc.rdtype).itemsize)


class _Clock:
    """Elapsed seconds of the work between ``start`` and ``stop``: CUDA
    events on a CUDA device, the host clock elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            self._a = torch.cuda.Event(enable_timing=True)
            self._b = torch.cuda.Event(enable_timing=True)
            self._a.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self._b.record()
            self._b.synchronize()
            return self._a.elapsed_time(self._b) / 1e3
        return time.perf_counter() - self._t0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_circuit(builder, iters: int = 5, seed: int = 0) -> Dict[str, float]:
    """Compile plus first run, then the steady-state run time (the mean of
    ``iters`` runs)."""
    gen = torch.Generator().manual_seed(seed)
    t0 = time.perf_counter()
    cc = _compiled(builder)
    cc.run(initial_index=0, generator=gen)
    _sync(cc.device)
    compile_s = time.perf_counter() - t0
    clock = _Clock(cc.device)
    clock.start()
    for _ in range(iters):
        cc.run(initial_index=0, generator=gen)
    steady_s = clock.stop() / iters
    sweeps = cc.num_sweeps
    out = {
        "compile_plus_first_s": compile_s,
        "steady_run_s": steady_s,
        "gate_passes": float(cc.num_passes),
        "hbm_sweeps": float(sweeps),
        "ms_per_sweep": steady_s / max(sweeps, 1) * 1e3,
    }
    out["effective_gbps"] = (
        sweeps * _sweep_bytes(cc) / steady_s / 1e9 if steady_s > 0 else float("inf")
    )
    return out


def _segment_ops(seg):
    """``(ops, repeat)`` of a unitary segment of ``CompiledCircuit.segments``."""
    if isinstance(seg, tuple):
        return seg[2], seg[1]
    return seg, 1


def pass_breakdown(builder) -> list:
    """Static per-sweep breakdown of the compiled circuit.

    One dict per state sweep, in execution order: which fused ops it
    retires, the window's row bits and step-type composition
    (``mix``/``low``/``cbf``/``rbf``/``cmix``/``diag``/...), whether the
    window kernel takes it, and the bytes it moves. Host-side only (no
    device work). Sweep boundaries come from ``plan_sweeps`` with the
    circuit's own admission and kernel policy, so they match execution.
    """
    from rustqip_tpu_torch.engine.compile import MeasureEntry
    from rustqip_tpu_torch.engine.real_apply import plan_sweeps

    cc = _compiled(builder)
    sweep_bytes = _sweep_bytes(cc)
    out = []
    for seg in cc.segments:
        if isinstance(seg, MeasureEntry):
            out.append({"kind": "measure", "ops": 0, "repeat": 1, "steps": {},
                        "kernel": False, "est_bytes": sweep_bytes})
            continue
        ops, repeat = _segment_ops(seg)
        for kind, payload, run in plan_sweeps(cc.n, ops, cc._kernel_ok, cc.admission):
            if kind == "op":
                out.append({"kind": type(payload).__name__, "ops": 1, "repeat": repeat,
                            "steps": {}, "kernel": False, "est_bytes": sweep_bytes})
                continue
            hq, steps = payload
            counts: Dict[str, int] = {}
            for s in steps:
                counts[s[0]] = counts.get(s[0], 0) + 1
            out.append({"kind": "window", "ops": len(run), "repeat": repeat,
                        "row_bits": list(hq), "steps": counts,
                        "kernel": kind == "kwindow", "est_bytes": sweep_bytes})
    return out


def sweep_plans(circuit) -> list:
    """``(pass_breakdown entry, plan)`` of each executed sweep of a circuit,
    in order, where ``plan`` is the compiled one-sweep plan that
    ``real_apply.run_sweeps`` runs (measurements skipped; a repeat body
    once). The walk behind both profilers."""
    from rustqip_tpu_torch.engine.compile import MeasureEntry

    cc = _compiled(circuit)
    plans = []
    for seg in cc.sweeps:
        if isinstance(seg, MeasureEntry):
            continue
        body = seg[2] if isinstance(seg, tuple) else seg
        plans.extend([sweep] for sweep in body)
    infos = [b for b in pass_breakdown(cc) if b["kind"] != "measure"]
    if len(infos) != len(plans):
        raise RuntimeError("pass_breakdown and the compiled plan disagree")
    return list(zip(infos, plans))


def _initial_pair(cc, seed):
    """Initial (R, C) planes on the circuit's device: ``seed=None`` ->
    |0..0>; an int seeds a random normalized state, drawn on the device
    (the same planes for a seed on one device)."""
    if seed is None:
        return cc._one_hot(0)
    _, R, C = geometry(cc.n)
    gen = torch.Generator(device=cc.device).manual_seed(seed)
    x = torch.randn((2, R, C), generator=gen, device=cc.device,
                    dtype=TORCH_REAL[cc.rdtype])
    x /= x.norm()
    return x[0], x[1]


def profile_passes(builder, iters: int = 3, seed=None) -> list:
    """Measured per-sweep timing: each sweep of the compiled plan runs once
    to warm up (the first launch of a kernel builds it) and then ``iters``
    times on the same planes, timed together; reports ms and effective GB/s
    per sweep beside its ``pass_breakdown`` entry.

    ``seed``: None profiles from |0..0>; an int from a seeded random
    normalized state. The planes carry each sweep's output into the next
    sweep's runs; they are the profiler's own, so every sweep that can
    updates them in place (``run_sweeps(..., inplace=True)``), as in
    ``CompiledCircuit.run``."""
    from rustqip_tpu_torch.engine.real_apply import run_sweeps

    cc = _compiled(builder)
    sweep_bytes = _sweep_bytes(cc)
    re, im = _initial_pair(cc, seed)
    clock = _Clock(cc.device)
    results = []
    for info, plan in sweep_plans(cc):
        re, im = run_sweeps(cc.n, plan, re, im, inplace=True)
        _sync(cc.device)
        clock.start()
        for _ in range(iters):
            re, im = run_sweeps(cc.n, plan, re, im, inplace=True)
        dt = clock.stop() / iters
        results.append({**info, "ms": dt * 1e3,
                        "gbps": sweep_bytes / dt / 1e9 if dt > 0 else float("inf")})
    return results


def profile_passes_fused(builder, extra_reps: int = 7, iters: int = 2, seed=None) -> list:
    """Measured per-sweep timing by repeat-count differencing: the whole
    plan runs with sweep k repeated ``reps[k]`` times, and sweep k's cost is
    ``(T(ones + e_k * extra_reps) - T(ones)) / extra_reps`` (each T the best
    of ``iters`` runs, each from a fresh initial state). ``num_sweeps + 1``
    timings of whole runs of the plan on the device, so a sweep's own
    launch gaps and the device's idle time between sweeps are counted as
    they fall in a real run. A non-positive difference flags the sweep as
    below the noise floor. Measurements are skipped; a repeat body is
    profiled at one iteration."""
    from rustqip_tpu_torch.engine.real_apply import run_sweeps

    cc = _compiled(builder)
    sweep_bytes = _sweep_bytes(cc)
    pairs = sweep_plans(cc)
    plans = [plan for _, plan in pairs]
    clock = _Clock(cc.device)

    def timed(reps) -> float:
        best = float("inf")
        for _ in range(iters):
            re, im = _initial_pair(cc, seed)
            _sync(cc.device)
            clock.start()
            for plan, r in zip(plans, reps):
                for _ in range(int(r)):
                    re, im = run_sweeps(cc.n, plan, re, im, inplace=True)
            best = min(best, clock.stop())
        return best

    ones = np.ones(len(plans), np.int64)
    timed(ones)  # warm-up: builds the kernels
    t_base = timed(ones)
    results = []
    for k, (info, _) in enumerate(pairs):
        reps = ones.copy()
        reps[k] += extra_reps
        delta = timed(reps) - t_base
        dt = max(delta, 0.0) / extra_reps
        below_floor = delta <= 0
        results.append({**info, "ms": dt * 1e3,
                        "gbps": float("nan") if below_floor else sweep_bytes / dt / 1e9,
                        "below_noise_floor": below_floor})
    return results


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of everything inside the block: host
    activity, and the card's kernels when CUDA is available. Yields the
    profiler; on exit writes the Chrome trace to ``log_dir/trace.json``
    (read it with ``trace_summary``, or view it in Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


#: Chrome-trace categories of work on the device.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_summary(path: str) -> Dict[str, float]:
    """Device activity of a Chrome trace written by ``trace``: the count of
    kernel events, the device's busy time (the union of its kernel, copy
    and set intervals) and the traced window (first to last event of any
    kind, host included), in ms, and the busy share of that window."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise ValueError(f"{path}: no complete events")
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("cat") in DEVICE_CATEGORIES)
    busy = 0.0
    end = float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    window = t1 - t0
    return {
        "kernel_events": sum(1 for e in events if e.get("cat") == "kernel"),
        "device_events": len(spans),
        "busy_ms": busy / 1e3,
        "window_ms": window / 1e3,
        "busy_share": busy / window if window > 0 else 0.0,
    }
