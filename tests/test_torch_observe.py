"""Observability in the port against the JAX package (twins of the observe
half of ``test_aux.py``): circuit statistics, ``pass_breakdown`` equal to
the JAX package's under the reference admission (kernel path on and off),
``CompiledCircuit.num_passes`` / ``num_sweeps`` equal to the JAX package's,
the profilers' schedules, and the trace hook with its summary.
"""

import json

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from rustqip_tpu.engine import pallas_kernels as ref_pk  # noqa: E402
from rustqip_tpu.prelude import LocalBuilder as JB  # noqa: E402
from rustqip_tpu.utils import observe as JO  # noqa: E402

from rustqip_tpu_torch.prelude import LocalBuilder as PB  # noqa: E402
from rustqip_tpu_torch.utils import observe as PO  # noqa: E402

torch.set_num_threads(1)  # the test runner keeps one worker per core busy


def build_example(b):
    q, r = b.qubit(), b.register(2)
    q = b.h(q)
    q = b.rz_pi_by(q, 4)
    q = b.rz(q, 0.123)
    q = b.apply_global_phase(q, 0.5)
    cb = b.condition_with(q)
    r = cb.apply_vec_matrix(r, np.eye(4).reshape(-1))
    q = cb.dissolve()
    r = b.repeat(3, lambda bb, rr: bb.h(bb.h(rr)), r)
    b.measure(r)
    b.measure_stochastic(q)


def qft(n):
    def build(b):
        if isinstance(b, PB):
            from rustqip_tpu_torch.algos import qfft
        else:
            from rustqip_tpu.algos import qfft
        qfft(b, b.register(n))

    return build


def grover(n):
    def build(b):
        if isinstance(b, PB):
            from rustqip_tpu_torch.algos.grover import grover_iteration
        else:
            from rustqip_tpu.algos.grover import grover_iteration
        r = b.h(b.register(n))
        grover_iteration(b, r, 0b1011001110101 & ((1 << n) - 1))

    return build


def adder(b):
    if isinstance(b, PB):
        from rustqip_tpu_torch.algos.arithmetic import add
    else:
        from rustqip_tpu.algos.arithmetic import add
    add(b, b.register(3), b.h(b.register(3)), b.register(4))


CIRCUITS = {"example": build_example, "qft14": qft(14), "grover14": grover(14),
            "adder10": adder}


def _pair(build, kernel):
    jb = JB(dtype="f32")
    pb = PB(dtype="f32", device="cpu", kernel_ok=kernel)
    build(jb)
    build(pb)
    return jb, pb


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_pass_breakdown_and_counts_match_jax(monkeypatch, name, kernel):
    """The same sweeps, in order, with the same kinds, op counts, row bits
    and step counts as the JAX package's ``pass_breakdown`` (its kernel path
    patched on, as its own tests do; the port on the CPU under the reference
    admission); ``num_passes`` equal, and ``num_sweeps`` the breakdown's
    sweep count (the JAX package's ``num_sweeps`` counts the plain window
    collection, so it is compared on the plain path)."""
    monkeypatch.setattr(ref_pk, "available", lambda: kernel)
    jb, pb = _pair(CIRCUITS[name], kernel)
    jcc, pcc = jb.compile(), pb.compile()
    assert jcc._kernel_ok == pcc._kernel_ok == kernel
    jbd, pbd = JO.pass_breakdown(jb), PO.pass_breakdown(pb)
    assert pbd == jbd
    assert pcc.num_passes == jcc.num_passes
    sweeps = sum(e["repeat"] for e in pbd if e["kind"] != "measure")
    assert pcc.num_sweeps == sweeps == sum(pcc.sweep_counts().values())
    if not kernel:
        assert pcc.num_sweeps == jcc.num_sweeps


def test_circuit_stats_match_jax():
    jb, pb = _pair(build_example, False)
    js, ps = JO.circuit_stats(jb), PO.circuit_stats(pb)
    assert (ps.n_qubits, ps.pipeline_depth, ps.unrolled_gates, ps.measurements) == (
        js.n_qubits, js.pipeline_depth, js.unrolled_gates, js.measurements)
    assert ps.gate_counts == js.gate_counts and ps.gate_counts["H"] >= 7
    assert ps.fused_passes == js.fused_passes >= 1
    assert ps.est_hbm_traffic_bytes == js.est_hbm_traffic_bytes > 0
    assert "qubits" in str(ps)


def test_pass_breakdown_static():
    b = PB(device="cpu")
    qft(8)(b)
    bd = PO.pass_breakdown(b)
    windows = [e for e in bd if e["kind"] == "window"]
    assert windows and all(e["est_bytes"] == 2 * (1 << 8) * 8 for e in bd)
    assert set().union(*(e["steps"] for e in windows)) & {"low", "cbf", "diag", "mix"}
    assert sum(e["ops"] * e["repeat"] for e in bd) == b.compile().num_passes
    ex = PB(device="cpu")
    build_example(ex)
    assert sum(e["kind"] == "measure" for e in PO.pass_breakdown(ex)) == 2


def test_profile_circuit_keys_match_jax():
    b = PB(device="cpu")
    b.h(b.register(4))
    out = PO.profile_circuit(b, iters=2)
    assert set(out) == {"compile_plus_first_s", "steady_run_s", "gate_passes",
                        "hbm_sweeps", "ms_per_sweep", "effective_gbps"}
    assert out["steady_run_s"] >= 0 and 1 <= out["hbm_sweeps"] <= out["gate_passes"]


@pytest.mark.parametrize("seed", [None, 3], ids=["zero_state", "seeded_state"])
def test_profile_passes_and_fused_share_the_schedule(seed):
    """One entry per executed sweep, in ``pass_breakdown``'s order, from
    |0..0> or a seeded random state (normalized, deterministic)."""
    from rustqip_tpu_torch.utils.observe import _initial_pair

    b = PB(device="cpu", kernel_ok=True)
    qft(6)(b)
    slow = PO.profile_passes(b, iters=1, seed=seed)
    fused = PO.profile_passes_fused(b, extra_reps=2, iters=1, seed=seed)
    static = [e for e in PO.pass_breakdown(b) if e["kind"] != "measure"]
    for out in (slow, fused):
        assert [(e["kind"], e["ops"]) for e in out] == [(e["kind"], e["ops"]) for e in static]
        assert all(e["ms"] >= 0 for e in out)
    assert all(e["gbps"] > 0 for e in slow)
    assert all(e["below_noise_floor"] or e["gbps"] > 0 for e in fused)
    if seed is not None:
        cc = b.compile()
        re, im = _initial_pair(cc, seed)
        assert abs(float((re ** 2 + im ** 2).sum()) - 1) < 1e-6
        assert float(im.abs().max()) > 0
        assert all((a == c).all() for a, c in zip((re, im), _initial_pair(cc, seed)))


def test_trace_writes_a_chrome_trace(tmp_path):
    b = PB(device="cpu")
    qft(6)(b)
    cc = b.compile()
    with PO.trace(str(tmp_path)) as prof:
        cc.run(0)
    assert prof is not None
    summary = PO.trace_summary(str(tmp_path / "trace.json"))
    assert summary["kernel_events"] == 0 and summary["busy_share"] == 0.0
    assert summary["window_ms"] > 0


def test_trace_summary_counts_the_union_of_device_intervals(tmp_path):
    """Busy time is the union of the device's intervals (overlaps counted
    once), over the window from the first event to the last."""
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "launch", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 10, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 30, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 70, "dur": 10},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 90},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = PO.trace_summary(str(path))
    assert s["kernel_events"] == 2 and s["device_events"] == 3
    assert s["busy_ms"] == pytest.approx(0.05) and s["window_ms"] == pytest.approx(0.1)
    assert s["busy_share"] == pytest.approx(0.5)
