"""The Shor order-finding cell at sizes a CPU test run holds: the
reference's closed form against its gate-by-gate ``solve`` and against the
port's own distribution in float64 (which pins the port's bit order), the
cell's jobs through the harness, the continued-fraction step on the closed
forms at the configuration's size, the TF32 control failing ``dist_gap``,
planted faults failing the run (a monomial pass that leaves its segments
unchanged, one that ignores its control, and the answer scaled by
1 + 1e-3 where it is made), the monomial readers and ``plain_ms.shor`` on
a synthetic trace, the bytes against the program's count, and the
traffic's jobs by seed.

Which of a permutation and its inverse a multiplication applies cannot
fail this cell: the counting register's distribution depends on the
order of the base alone, and a^-1 has the order of a (after the
multiplications the state is sum_x |rev(x)> |a^(+-x) mod N>, whose work
values repeat with period r either way). The port's whole-state tests
catch that fault (``tests/test_torch_monomial.py`` against the route the
pass replaced and the JAX package, ``tests/test_torch_gpu_monomial.py`` on
the card).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _small import CPU
from portbench import harness, jobs, limits, roofline, trace_math
from portbench.circuits import shor as shor_circuit
from portbench.reference import shor
from portbench.reference.precision import EXACT
from portbench.tests.test_portbench_trace import US, ev
from rustqip_tpu_torch.algos.shor import period_from_distribution
from rustqip_tpu_torch.engine import compile as port_compile
from rustqip_tpu_torch.engine import monomial
from rustqip_tpu_torch.prelude import LocalBuilder
from rustqip_tpu_torch.utils import observe

NAME = "shor31.distribution"
#: Ten work qubits as in the configuration, six counting qubits: every
#: multiplication is a controlled op of 11 indices and takes the pass.
SMALL = {"num_qubits": 16, "counting_qubits": 6, "work_qubits": 10}
CFG_SIZES = [
    ({"num_qubits": 11, "counting_qubits": 6, "work_qubits": 5, "modulus": 21}, (2, 4, 8)),
    ({"num_qubits": 13, "counting_qubits": 3, "work_qubits": 10, "modulus": 1007}, (2, 4)),
    ({"num_qubits": 19, "counting_qubits": 9, "work_qubits": 10, "modulus": 1007}, (3, 5)),
]


@pytest.mark.parametrize("cfg, bases", CFG_SIZES, ids=["N21_t6", "N1007_t3", "N1007_t9"])
def test_closed_form_agrees_with_solve_and_the_port(cfg, bases):
    """Within 1e-12 in float64, in the port's bit order: the closed form,
    the gate-by-gate reference and the port's own f64 run (counting qubit
    q in bit q of the outcome value)."""
    t = cfg["counting_qubits"]
    for a in bases:
        ref = shor.solve(cfg, {"base": a}, 0, EXACT)
        closed = shor.closed_form(t, shor.order(a, cfg["modulus"]), device="cpu")
        assert np.abs(ref["probs"] - closed).max() < 1e-12
        b = LocalBuilder(dtype="f64", device="cpu")
        shor_circuit.build(b, cfg, {"base": a})
        _, _, results = b.compile().run(0)
        probs = next(r for r in results if not isinstance(r, tuple)).numpy()
        assert np.abs(probs - closed).max() < 1e-12


def test_bases_make_every_multiplication_nontrivial():
    pool = shor.bases(1007)
    assert 2 in pool and all(shor.order(a, 1007) & (shor.order(a, 1007) - 1) for a in pool)
    assert all(pow(a, 1 << j, 1007) != 1 for a in pool for j in range(21))
    assert shor.order(2, 1007) == 468 and max(shor.order(a, 1007) for a in pool) == 468


def test_cell_jobs_agree_with_the_reference():
    before = dict(observe.COUNTS)
    r = harness.run_cell(NAME, 2**31 + 4242, 0.6, False, cfg_overrides=SMALL, **CPU)
    assert r["correct"], r
    assert r["attempted"] >= 2 and r["failed"] == 0
    assert r["checks"]["dist_gap"]["value"] <= r["checks"]["dist_gap"]["limit"] / 10
    assert set(r["metrics"]) == {"jobs_per_s", "setup_s"}  # peak_gib reads a card
    runs = observe.COUNTS["circuit_runs"] - before.get("circuit_runs", 0)
    assert observe.COUNTS["monomial_pass"] - before.get("monomial_pass", 0) == 6 * runs


def _textbook(t, r):
    """Nielsen and Chuang's distribution (the exponent read big-endian by
    the inverse QFT), in the port's outcome order."""
    T = 1 << t
    y = np.arange(T, dtype=np.int64)
    K, rem = divmod(T, r)
    frac = (y * r) % T
    hit = frac == 0
    den = np.sin(np.pi * frac / T) ** 2

    def F(k):
        out = np.full(T, float(k * k))
        out[~hit] = np.sin(np.pi * ((k * frac[~hit]) % T) / T) ** 2 / den[~hit]
        return out

    return ((rem * F(K + 1) + (r - rem) * F(K)) / float(T) ** 2)[shor.flip(t, y)]


def test_continued_fractions_on_the_closed_forms():
    """At the configuration's size, for the base a seed draws: the
    continued-fraction step (``algos.shor.period_from_distribution``)
    recovers the order from the textbook's distribution, but not from the
    one the port's circuit makes (here it returns 5 r, a multiple that
    passes its check a^r' = 1), whose inverse QFT reads the exponent
    bit-reversed (the JAX package's bit order, PERF.md §4)."""
    cfg = harness.load_cell(NAME).cfg
    t, N = cfg["counting_qubits"], cfg["modulus"]
    a = shor.draw_params(cfg, jobs.rng(2**31 + 7, jobs.SETUP))["base"]
    r = shor.order(a, N)
    assert period_from_distribution(_textbook(t, r), a, N, t) == r
    assert period_from_distribution(shor.closed_form(t, r, device="cpu"), a, N, t) != r


@pytest.mark.parametrize("seed", [11, 3_000_000_019])
def test_control_fails_dist_gap(seed):
    checks, correct = limits.control_numbers(NAME, seed, 3, "cpu", SMALL)
    assert not correct
    assert checks["dist_gap"]["value"] > 3 * checks["dist_gap"]["limit"], checks


def _unchanged(monkeypatch):
    monkeypatch.setattr(monomial, "monomial_pass",
                        lambda n, plan, xr, xi, inplace=False, kernel=True: (xr, xi))


def _ignores_control(monkeypatch):
    plan_of = monomial.plan_of

    def uncontrolled(n, op):
        plan = plan_of(n, op)
        return None if plan is None else dataclasses.replace(plan, cbits=(), _dev={})

    monkeypatch.setattr(monomial, "plan_of", uncontrolled)


def _answer_scaled(monkeypatch):
    sweeps = port_compile.run_sweeps

    def scaled(n, s, re, im, **k):
        re, im = sweeps(n, s, re, im, **k)
        return re * (1 + 1e-3), im * (1 + 1e-3)

    monkeypatch.setattr(port_compile, "run_sweeps", scaled)


@pytest.mark.parametrize("fault", [_unchanged, _ignores_control, _answer_scaled],
                         ids=["segments_unchanged", "control_ignored", "answer_scaled"])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    r = harness.run_cell(NAME, 2**31 + 99, 0.3, False, cfg_overrides=SMALL, **CPU)
    assert r["failed"] == 0
    assert not r["correct"], r["checks"]


def test_monomial_readers_on_a_synthetic_trace():
    """Two jobs, two monomial launches of 30 and 20 us and a window launch:
    ``monomial_ms`` is 25 us a job, ``monomial_roofline`` the
    configuration's least bytes a job at the HBM rate over it; both None
    without such a launch or without a trace."""
    events = [ev(trace_math.JOB_SPAN, "user_annotation", 0, 100),
              ev(trace_math.JOB_SPAN, "user_annotation", 100, 100),
              ev("void monomial_pass_kernel<true, false>(float*, float*, unsigned int const*, "
                 "MonoPlan)", "kernel", 10, 30),
              ev("void monomial_pass_kernel<true, false>(float*, float*, unsigned int const*, "
                 "MonoPlan)", "kernel", 120, 20),
              ev("void window_sweep_kernel<2>(Params)", "kernel", 150, 30)]
    view = trace_math.view(trace_math.chrome_source({"traceEvents": events}))
    cfg = harness.load_cell(NAME).cfg
    ctx = SimpleNamespace(trace=view, jobs=[SimpleNamespace(spans={})] * 2, n=31, cfg=cfg,
                          root=harness.ROOT)
    ms = harness.metric_reader("monomial_ms").read(ctx)
    assert ms == pytest.approx(25 * US * 1e3)
    bytes_a_job = 21 * (1 << 30) * 2 * 4 * 2
    assert harness.metric_reader("monomial_roofline").read(ctx) == pytest.approx(
        100 * bytes_a_job / roofline.HBM_BYTES_PER_S / (25 * US))
    ctx.trace = trace_math.view(trace_math.chrome_source({"traceEvents": events[:2] + events[4:]}))
    assert harness.metric_reader("monomial_ms").read(ctx) is None
    assert harness.metric_reader("monomial_roofline").read(ctx) is None
    ctx.trace = None
    assert harness.metric_reader("monomial_roofline").read(ctx) is None


def test_plain_ms_shor_leaves_out_the_monomial_pass():
    """``plain_ms.shor`` takes the device time that neither the window
    kernel, the row swap nor the monomial pass claims (here one torch
    kernel of 10 us and a copy of 6 us over two jobs); ``plain_ms`` would
    count the monomial launches too. The cell reads every device metric of
    its layers."""
    events = [ev(trace_math.JOB_SPAN, "user_annotation", 0, 100),
              ev(trace_math.JOB_SPAN, "user_annotation", 100, 100),
              ev("void monomial_pass_kernel<true, false>(float*, float*, unsigned int const*, "
                 "MonoPlan)", "kernel", 10, 30),
              ev("void at::native::vectorized_elementwise_kernel<4>(...)", "kernel", 50, 10),
              ev("row_swap_kernel", "kernel", 70, 20),
              ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 110, 6),
              ev("void window_sweep_kernel<2>(Params)", "kernel", 150, 30)]
    view = trace_math.view(trace_math.chrome_source({"traceEvents": events}))
    ctx = SimpleNamespace(trace=view, jobs=[SimpleNamespace(spans={})] * 2, n=31,
                          cfg=harness.load_cell(NAME).cfg, root=harness.ROOT)
    assert harness.metric_reader("plain_ms.shor").read(ctx) == pytest.approx(8 * US * 1e3)
    assert harness.metric_reader("plain_ms").read(ctx) == pytest.approx(23 * US * 1e3)
    ctx.trace = None
    assert harness.metric_reader("plain_ms.shor").read(ctx) is None
    assert {m["name"] for m in harness.load_cell(NAME).per_layer} == {
        "window_ms", "window_roofline", "row_swap_ms", "idle_share", "monomial_ms",
        "monomial_roofline", "plain_ms.shor"}


def test_roofline_bytes_are_the_programs_count():
    """The bytes the reader works out from the configuration equal what the
    program counts (``COUNTS["monomial_bytes"]``) a run, at a CPU size."""
    from portbench.metrics import monomial_roofline

    cfg = dict(harness.load_cell(NAME).cfg, **SMALL)
    b = LocalBuilder(dtype="f32", device="cpu")
    shor_circuit.build(b, cfg, {"base": 2})
    cc = b.compile()
    before = observe.COUNTS["monomial_bytes"]
    cc.run(0)
    assert observe.COUNTS["monomial_bytes"] - before == monomial_roofline.least_bytes(cfg)


def test_same_seed_same_jobs_and_the_entry_validates():
    cell = harness.load_cell(NAME)
    big = 2**31 + 987654321
    a = jobs.Traffic(cell.cfg, cell.mix, cell.reference, big, cell.entry)
    b = jobs.Traffic(cell.cfg, cell.mix, cell.reference, big, cell.entry)
    for i in (0, 1, 57):
        ja, jb = a.job(i), b.job(i)
        assert (ja.params, ja.init, ja.gen_seed, ja.read) == (jb.params, jb.init, jb.gen_seed,
                                                             None)
    other = jobs.Traffic(cell.cfg, cell.mix, cell.reference, big + 2, cell.entry)
    assert a.job(0).key() != other.job(0).key()
    for bad in ({"input": "uniform_basis"}, {"readout": "collapse"}):
        with pytest.raises(ValueError):
            jobs.validate_mix(dict(cell.mix, **bad), cell.entry)
    assert torch.get_num_threads() == 1
