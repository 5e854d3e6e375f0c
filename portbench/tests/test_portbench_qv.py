"""The quantum volume cell at sizes a CPU test run holds: the reference's
pieces (the Haar draw, the model circuit's pairs, ``gate2`` against the
dense 4 x 4 on the whole state), the cell's jobs through the port against
the reference, the TF32 control failing ``amp_gap``, and planted faults
failing the run: a plain strip window or a kernel window returning its
state unchanged, and the answer scaled by 1 + 1e-3 where it is made.
(``_small.py`` is the other cells'; this cell's sizes are below.)"""

import numpy as np
import pytest
import torch

from _small import CPU
from portbench import harness, limits
from portbench.reference import qv, statevec
from rustqip_tpu_torch.engine import compile as port_compile
from rustqip_tpu_torch.engine import real_apply

NAME = "qv28.amplitudes"
#: 12 qubits plans plain windows alone on the CPU; 14 plans kernel windows too.
SMALL = {"num_qubits": 12, "depth": 12}
FAULT = {"num_qubits": 14, "depth": 14}


def test_haar_su4_is_special_unitary():
    rng = np.random.default_rng(2**31 + 1)
    us = [qv.haar_su4(rng) for _ in range(2000)]
    for u in us[:50]:
        assert np.abs(u.conj().T @ u - np.eye(4)).max() < 1e-13
        assert abs(np.linalg.det(u) - 1) < 1e-13
    # Haar: E|U_ij|^2 = 1/4 and E|U_ij|^4 = 1/10 for every entry
    sq = np.abs(np.array(us)) ** 2
    assert np.abs(sq.mean(axis=0) - 0.25).max() < 0.02
    assert np.abs((sq ** 2).mean(axis=0) - 0.1).max() < 0.015


def test_model_circuit_pairs_every_qubit_once_a_layer():
    n, depth = 9, 5
    layers = qv.model_circuit(n, depth, 3, 77)
    assert len(layers) == depth
    for layer in layers:
        qubits = [q for a, c, _ in layer for q in (a, c)]
        assert len(layer) == n // 2 and len(set(qubits)) == len(qubits) == 2 * (n // 2)
    again = qv.model_circuit(n, depth, 3, 77)
    assert all(np.array_equal(u, v) and (a, c) == (x, y)
               for la, lb in zip(layers, again) for (a, c, u), (x, y, v) in zip(la, lb))
    # the pairs come from the pairs seed alone, the unitaries from the circuit seed alone
    other = qv.model_circuit(n, depth, 3, 78)
    assert all((a, c) == (x, y) and not np.allclose(u, v)
               for la, lb in zip(layers, other) for (a, c, u), (x, y, v) in zip(la, lb))
    assert [[g[:2] for g in la] for la in qv.model_circuit(n, depth, 4, 77)] != \
        [[g[:2] for g in la] for la in layers]


@pytest.mark.parametrize("a, c", [(0, 3), (3, 0), (1, 2), (2, 4)])
def test_gate2_equals_the_dense_operator(a, c):
    """``gate2`` against U on qubits (a, c) as a 2^n x 2^n matrix, built
    from the index bits (qubit q is bit n - 1 - q)."""
    n = 5
    rng = np.random.default_rng(a * 10 + c)
    u = qv.haar_su4(rng)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    full = np.zeros((1 << n, 1 << n), dtype=np.complex128)
    for row in range(1 << n):
        for col in range(1 << n):
            rest = ~((1 << (n - 1 - a)) | (1 << (n - 1 - c)))
            if row & rest != col & rest:
                continue
            bits = lambda x: 2 * ((x >> (n - 1 - a)) & 1) + ((x >> (n - 1 - c)) & 1)  # noqa: E731
            full[row, col] = u[bits(row), bits(col)]
    got = qv.gate2(torch.tensor(v), n, a, c, u).numpy()
    assert np.abs(got - full @ v).max() < 1e-12
    assert abs(qv.gate2(statevec.basis(n, 0), n, a, c, u).abs().square().sum().item() - 1) < 1e-12


def test_cell_jobs_agree_with_the_reference():
    r = harness.run_cell(NAME, 2**31 + 4242, 0.6, False, cfg_overrides=SMALL, **CPU)
    assert r["correct"], r
    assert r["attempted"] >= 2 and r["failed"] == 0
    assert r["checks"]["amp_gap"]["value"] <= r["checks"]["amp_gap"]["limit"] / 10
    assert set(r["metrics"]) == {"jobs_per_s", "setup_s"}  # peak_gib reads a card


@pytest.mark.parametrize("seed", [11, 2**31 + 5, 3_000_000_019])
def test_control_fails_amp_gap(seed):
    checks, correct = limits.control_numbers(NAME, seed, 4, "cpu", SMALL)
    assert not correct
    assert checks["amp_gap"]["value"] > 3 * checks["amp_gap"]["limit"], checks


def _plain_window_unchanged(monkeypatch):
    monkeypatch.setattr(real_apply, "_window_sweep_ri", lambda n, w, re, im, lk=True: (re, im))


def _kernel_window_unchanged(monkeypatch):
    monkeypatch.setattr(real_apply.window_kernel, "window_sweep",
                        lambda n, re, im, *a, **k: (re, im))


def _answer_scaled(monkeypatch):
    sweeps = port_compile.run_sweeps

    def scaled(n, s, re, im, **k):
        re, im = sweeps(n, s, re, im, **k)
        return re * (1 + 1e-3), im * (1 + 1e-3)

    monkeypatch.setattr(port_compile, "run_sweeps", scaled)


@pytest.mark.parametrize("fault", [_plain_window_unchanged, _kernel_window_unchanged,
                                   _answer_scaled],
                         ids=["plain_window_unchanged", "kernel_window_unchanged",
                              "answer_scaled"])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    r = harness.run_cell(NAME, 2**31 + 99, 0.3, False, cfg_overrides=FAULT, **CPU)
    assert r["failed"] == 0
    assert not r["correct"], r["checks"]


def test_plain_window_roofline_reader(monkeypatch):
    """The share on a synthetic trace of two jobs (a window launch and
    60 us of other device work): a run's plain-window bytes over the
    runs, at the HBM rate, over ``plain_ms``'s time a job; None with the
    counts absent (as the parent's program keeps them) or zero, and
    without a trace."""
    from types import SimpleNamespace

    from portbench import roofline, trace_math
    from portbench.tests.test_portbench_trace import US, ev
    from rustqip_tpu_torch.utils import observe

    events = [ev(trace_math.JOB_SPAN, "user_annotation", 0, 100),
              ev(trace_math.JOB_SPAN, "user_annotation", 100, 100),
              ev("void window_sweep_kernel<2>(Params)", "kernel", 10, 30),
              ev("void at::native::vectorized_elementwise_kernel<4>(...)", "kernel", 50, 40),
              ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 120, 20)]
    view = trace_math.view(trace_math.chrome_source({"traceEvents": events}))
    ctx = SimpleNamespace(trace=view, jobs=[SimpleNamespace(spans={})] * 2, n=28,
                          root=harness.ROOT)
    read = harness.metric_reader("plain_window_roofline").read
    counts = {"circuit_runs": 4, "window_plain_bytes": 4 * 3 * observe.pass_bytes(28, 4)}
    monkeypatch.setattr(observe, "COUNTS", counts)
    want = 100 * 3 * roofline.pass_bound_s(28) / (30 * US)
    assert read(ctx) == pytest.approx(want)
    monkeypatch.setattr(observe, "COUNTS", {"circuit_runs": 4})
    assert read(ctx) is None
    monkeypatch.setattr(observe, "COUNTS", {})
    assert read(ctx) is None
    monkeypatch.setattr(observe, "COUNTS", counts)
    ctx.trace = None
    assert read(ctx) is None
