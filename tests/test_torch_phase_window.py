"""A phase product whose moduli drift from 1 as a kernel window's ``diag``
step, host only.

``phase_estimate`` builds U^(2^k) by repeated squaring, so the diagonals of
a QPE phase product drift from unit modulus (about 1e-9 at 27 counting
qubits) and ``_phase_plan`` gives them a log-magnitude group. The H100's
admission (``HopperSmemAdmission.diag_mag_max`` = 2^-26) lets a window's
``diag`` step carry the angle group alone when that group's absolute
coefficients sum to at most 2^-26: in float32, the only precision the
window kernel serves, its factor is exactly 1. Here: that exactness over
every index at n = 16-20 for coefficients of either sign on a constant,
row, lane and mixed monomials, the refusal just past the threshold, no
kernel window in a float64 circuit, QPE-28's plan (the phase product a
kernel window of its own, since an angle-mode diag joins no window of
h >= 1 on the H100), QPE-14 and QPE-18 through that plan against the
benchmark's float64 reference with the rule counted once a run
(``observe.COUNTS["diag_mag_rounded"]``), and the reference admission's QPE
plans equal to the JAX package's, the phase product a plain pass."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.circuits import qpe as qpe_circuit  # noqa: E402
from portbench.reference import qpe as qpe_reference  # noqa: E402
from rustqip_tpu_torch.engine.admission import HOPPER, TPU_REFERENCE  # noqa: E402
from rustqip_tpu_torch.engine.apply import (  # noqa: E402
    _eval_bilinear_2d,
    _phase_mul_ri,
    _phase_plan,
)
from rustqip_tpu_torch.engine.compile import MeasureEntry  # noqa: E402
from rustqip_tpu_torch.engine.real_apply import (  # noqa: E402
    _abs_coeff_sum,
    _window_diag_plan,
    compile_sweeps,
    run_sweeps,
)
from rustqip_tpu_torch.ops.matrix_ops import DenseOp, PhaseProductOp  # noqa: E402
from rustqip_tpu_torch.prelude import LocalBuilder  # noqa: E402
from rustqip_tpu_torch.types import geometry  # noqa: E402
from rustqip_tpu_torch.utils import observe  # noqa: E402
from test_torch_qv import _on_the_h100  # noqa: E402

torch.set_num_threads(1)  # the test runner keeps one worker per core busy

#: Just inside and just past the threshold, by one part in 2^20: far more
#: than the float64 noise of log(exp(c)) over the op's ten coefficients.
INSIDE = HOPPER.diag_mag_max * (1 - 2.0 ** -20)
PAST = HOPPER.diag_mag_max * (1 + 2.0 ** -20)


def _drifted_op(n, total, sign, seed=0):
    """A PhaseProductOp whose log-magnitude coefficients, all of sign
    ``sign``, lie on a constant, three row, three lane and three mixed
    monomials and sum to ``total`` in absolute value; every entry also
    carries a phase drawn from ``seed``."""
    m, _, _ = geometry(n)
    n_m = n - m
    rows, lanes = (0, n_m // 2, n_m - 1), (n_m, n_m + 3, n - 1)
    unit = sign * total / 16
    rng = np.random.default_rng(seed)

    def entry(logmag):
        return complex(np.exp(logmag + 1j * rng.uniform(-np.pi, np.pi)))

    terms = [((rows[0],), (entry(unit), entry(unit)))]  # the constant
    terms += [((q,), (1.0, entry(unit))) for q in rows + lanes]
    terms += [((r, c), (1.0, 1.0, 1.0, entry(3 * unit))) for r, c in zip(rows, lanes)]
    return PhaseProductOp(tuple(terms))


def _sweeps(cc):
    return [s for seg in cc.sweeps if not isinstance(seg, MeasureEntry) for s in seg]


def _qpe_cfg(n):
    return {"num_qubits": n, "counting_qubits": n - 1, "target_qubits": 1,
            "phase_bits": n - 1}


def _qpe(n, dtype, j):
    b = LocalBuilder(dtype=dtype, device="cpu", kernel_ok=True)
    qpe_circuit.build(b, _qpe_cfg(n), {"phase_int": j})
    return b.compile()


@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("n", [16, 18, 20])
def test_rounded_log_magnitude_is_exactly_one_in_float32(n, sign):
    """At the threshold the magnitude factor is 1.0f at every index, the
    H100's admission takes the diagonal as a kernel window's diag step
    (the reference admission does not), and that window computes what the
    plain float32 pass computes."""
    op = _drifted_op(n, INSIDE, sign, seed=n)
    angle_g, mag_g = _phase_plan(n, op.terms)
    assert mag_g is not None
    assert INSIDE * (1 - 2.0 ** -21) < _abs_coeff_sum(mag_g) <= HOPPER.diag_mag_max
    _, R, C = geometry(n)
    x = _eval_bilinear_2d(n, mag_g, torch.zeros((R, C), dtype=torch.float32))
    # the index with every bit set sums every coefficient
    peak = x.max() if sign > 0 else -x.min()
    assert peak.item() >= 0.99 * INSIDE
    assert torch.equal(torch.exp(x), torch.ones_like(x))

    assert _window_diag_plan(n, op, HOPPER.diag_mag_max) == angle_g
    assert _window_diag_plan(n, op, TPU_REFERENCE.diag_mag_max) is None
    assert [k for k, _, _ in compile_sweeps(n, [op], True, TPU_REFERENCE)] == ["op"]
    sweeps = compile_sweeps(n, [op], True, HOPPER)
    assert [k for k, _, _ in sweeps] == ["kwindow"] and sweeps[0][1][2].mag_rounded

    rng = np.random.default_rng(n + 7)
    re = torch.as_tensor(rng.normal(size=(R, C)), dtype=torch.float32)
    im = torch.as_tensor(rng.normal(size=(R, C)), dtype=torch.float32)
    want = _phase_mul_ri(n, op, re, im)
    before = observe.COUNTS["diag_mag_rounded"]
    got = run_sweeps(n, sweeps, re.clone(), im.clone())
    assert observe.COUNTS["diag_mag_rounded"] == before + 1
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 2e-5 * w.abs().max().item()


@pytest.mark.parametrize("sign", [1, -1])
def test_log_magnitude_past_the_threshold_is_refused(sign):
    """Just past 2^-26 the H100's admission refuses the step and the op
    stays a plain pass; eight times the threshold, exp in float32 is no
    longer 1 at the index that sums every coefficient."""
    n = 18
    op = _drifted_op(n, PAST, sign)
    _, mag_g = _phase_plan(n, op.terms)
    assert _abs_coeff_sum(mag_g) > HOPPER.diag_mag_max
    assert _window_diag_plan(n, op, HOPPER.diag_mag_max) is None
    assert [k for k, _, _ in compile_sweeps(n, [op], True, HOPPER)] == ["op"]

    _, R, C = geometry(n)
    _, mag8 = _phase_plan(n, _drifted_op(n, 8 * HOPPER.diag_mag_max, sign).terms)
    x = _eval_bilinear_2d(n, mag8, torch.zeros((R, C), dtype=torch.float32))
    assert not torch.equal(torch.exp(x), torch.ones_like(x))


def test_float64_circuit_plans_no_kernel_window(monkeypatch):
    """With the H100's admission a float64 QPE-12 plans no kernel window
    (``kernel_policy``), so its drifted phase product stays a plain pass;
    the same circuit in float32 plans it inside a kernel window."""
    _on_the_h100(monkeypatch)
    j = 2 * 1234 + 1
    f64 = _qpe(12, "f64", j)
    assert not f64._kernel_ok and f64.sweep_counts()["kwindow"] == 0
    assert any(isinstance(p, PhaseProductOp) for k, p, _ in _sweeps(f64) if k == "op")
    f32 = _qpe(12, "f32", j)
    assert f32._kernel_ok
    assert not any(isinstance(p, PhaseProductOp) for k, p, _ in _sweeps(f32) if k == "op")
    assert sum(p[2].mag_rounded for k, p, _ in _sweeps(f32) if k == "kwindow") == 1


def test_qpe28_plan_on_the_h100(monkeypatch):
    """Host only: the benchmark's QPE-28 with the H100's admission plans 11
    kernel windows and 2 ops (the 5-qubit dense head and the swap); its
    phase product (21 mixed angle monomials on distinct row qubits, a
    log-magnitude group of about 3e-9) takes angle mode, so it is the lone
    diag step of an h = 0 window on the register path."""
    _on_the_h100(monkeypatch)
    cfg = json.loads((ROOT / "portbench" / "configs" / "qpe28.json").read_text())
    b = LocalBuilder(dtype="f32", device="cpu", kernel_ok=True)
    qpe_circuit.build(b, cfg, {"phase_int": (1 << 26) + 12345})
    cc = b.compile()
    assert cc.sweep_counts() == {"kwindow": 11, "window": 0, "op": 2}
    sweeps = _sweeps(cc)
    assert [type(p).__name__ for k, p, _ in sweeps if k == "op"] == ["DenseOp", "SwapOp"]
    rounded = [(p[2], run) for k, p, run in sweeps if k == "kwindow" and p[2].mag_rounded]
    assert len(rounded) == 1
    prog, run = rounded[0]
    assert prog.path == "registers" and prog.h == 0 and prog.kinds == ("diag",)
    (phase,) = run
    angle_g, mag_g = _phase_plan(28, phase.terms)
    assert len(angle_g[3]) == 21 and 0 < _abs_coeff_sum(mag_g) <= HOPPER.diag_mag_max


@pytest.mark.parametrize("groups, windows", [(4, [("diag", "mix")]), (5, [("mix",), ("diag",)])])
def test_angle_mode_diag_takes_a_window_of_its_own(groups, windows):
    """With the H100's admission a diag with more than ``DIAG_MASK_MAX``
    row-support groups (angle mode) joins no window of h >= 1: after a gate
    on a high row qubit it forms a window of its own, where one with four
    groups joins the gate's window. The reference admission takes both
    into the gate's window."""
    n = 20
    n_m = n - geometry(n)[0]
    h = DenseOp((1,), np.array([[1, 1], [1, -1]]) / np.sqrt(2))
    phase = PhaseProductOp(tuple(
        ((q, n - 1), (1.0, 1.0, 1.0, complex(np.exp(0.3j * (q + 1)))))
        for q in range(2, 2 + groups)
    ))
    assert 2 + groups <= n_m
    plan = compile_sweeps(n, [h, phase], True, HOPPER)
    assert [(k, p[2].kinds) for k, p, _ in plan] == [("kwindow", w) for w in windows]
    assert [k for k, _, _ in compile_sweeps(n, [h, phase], True, TPU_REFERENCE)] == ["kwindow"]


def test_lane_phase_product_keeps_its_magnitude():
    """A drifted phase product on lane qubits alone joins a window as a
    lane matrix, which keeps its magnitude: the H100's admission leaves
    nothing out, and the window is not counted."""
    n = 18
    n_m = n - geometry(n)[0]
    h = DenseOp((1,), np.array([[1, 1], [1, -1]]) / np.sqrt(2))
    lane = PhaseProductOp((((n_m, n - 1), (1.0, 1.0, 1.0, complex(np.exp(1e-10 + 0.3j)))),))
    assert _phase_plan(n, lane.terms)[1] is not None
    plan = compile_sweeps(n, [h, lane], True, HOPPER)
    assert [(k, p[2].kinds) for k, p, _ in plan] == [("kwindow", ("low", "mix"))]
    assert not plan[0][1][2].mag_rounded
    _, R, C = geometry(n)
    before = observe.COUNTS["diag_mag_rounded"]
    run_sweeps(n, plan, torch.ones((R, C)), torch.zeros((R, C)))
    assert observe.COUNTS["diag_mag_rounded"] == before


@pytest.mark.parametrize("n, j", [(14, 2 * 3001 + 1), (18, 2 * 55555 + 1)])
def test_qpe_through_the_window_matches_the_reference(monkeypatch, n, j):
    """QPE-14 and QPE-18 in float32 with the H100's admission (the kernel
    windows through their plain versions): the phase product rides a
    kernel window, counted once a run, and the collapse reads the float64
    reference's outcome at its probability within 1e-5."""
    _on_the_h100(monkeypatch)
    cc = _qpe(n, "f32", j)
    assert not any(isinstance(p, PhaseProductOp) for k, p, _ in _sweeps(cc) if k == "op")
    cfg, params = _qpe_cfg(n), {"phase_int": j}
    ref = qpe_reference.solve(cfg, params, 0)
    assert ref["top"] == j
    for seed in (1, 2):
        before = observe.COUNTS["diag_mag_rounded"]
        gen = torch.Generator()
        gen.manual_seed(seed)
        _, _, results = cc.run(0, generator=gen)
        assert observe.COUNTS["diag_mag_rounded"] == before + 1
        outcome, prob = next(r for r in results if isinstance(r, tuple))
        y = qpe_reference.flip(n - 1, outcome)
        assert y == ref["top"]
        assert abs(float(prob) - float(ref["probs"][y])) <= 1e-5


def test_reference_admission_plans_qpe_as_the_jax_package(monkeypatch):
    """Under ``TpuReferenceAdmission`` (the CPU's default) QPE-14's fused
    segments and plans equal the JAX package's entry by entry, and its
    drifted phase product stays a plain pass that no window counts."""
    pytest.importorskip("jax")
    from test_torch_planner import _check_plans, _ref_circuit, _same, ref_pk

    from rustqip_tpu_torch.interop import ops_from_reference
    from rustqip_tpu_torch.ops.matrix_ops import op_fingerprint

    monkeypatch.setattr(ref_pk, "available", lambda: True)
    n, j = 14, 2 * 3001 + 1
    u = np.diag([1.0, np.exp(2j * np.pi * j / (1 << (n - 1)))])

    def build(b, side):
        if side == "ref":
            from rustqip_tpu.algos import phase_estimate
        else:
            from rustqip_tpu_torch.algos import phase_estimate
        phase_estimate(b, u, n - 1, prepare=lambda bb, t: bb.x(t))

    rcc, pcc = _ref_circuit(build, n)
    assert pcc.admission is TPU_REFERENCE and pcc._kernel_ok
    assert len(pcc.segments) == len(rcc.segments)
    phase_ops = 0
    for rs, ps in zip(rcc.segments, pcc.segments):
        if not isinstance(rs, (list, tuple)):  # the measurement
            assert type(rs).__name__ == type(ps).__name__
            _same(vars(rs), vars(ps))
            continue
        if isinstance(rs, tuple):
            _same(rs[:2], ps[:2])
            rs, ps = rs[2], ps[2]
        assert [op_fingerprint(o) for o in ps] == [
            op_fingerprint(o) for o in ops_from_reference(rs)
        ]
        plan = _check_plans(n, rs)
        phase_ops += sum(isinstance(p, PhaseProductOp) for k, p, _ in plan if k == "op")
    assert phase_ops == 1
    assert not any(p[2].mag_rounded for k, p, _ in _sweeps(pcc) if k == "kwindow")
