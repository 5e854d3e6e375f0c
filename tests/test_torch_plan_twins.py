"""Port twins of the JAX package's planner families that had none:
``tests/test_step_merge.py`` and ``tests/test_sweep_pairing.py``. Each op
list plans entry for entry like the JAX package's planner (kernel path on
and off, the reference admission), and the port's planned run equals its
op-by-op run: the kernel path in float32 within 1e-4 at n = 19 (the JAX
tests' bar, there in interpret mode, here the kernel's plain version), the
plain path in float64 within 1e-10 at n = 10. Cases already held by
``test_torch_planner.py`` (QFT, Grover and the bench arms) are not repeated;
the environment-knob cases have no port counterpart (the port reads none)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from rustqip_tpu.engine import real_apply as ref_ra  # noqa: E402
from rustqip_tpu.ops import gates  # noqa: E402
from rustqip_tpu.ops import matrix_ops as R  # noqa: E402

from rustqip_tpu_torch.algos import grover_search  # noqa: E402
from rustqip_tpu_torch.algos.arithmetic import add  # noqa: E402
from rustqip_tpu_torch.engine import real_apply as port_ra  # noqa: E402
from rustqip_tpu_torch.engine.admission import (  # noqa: E402
    TPU_REFERENCE,
    WINDOW_KERNEL_MAX_LOW,
)
from rustqip_tpu_torch.engine.fusion import fuse_ops  # noqa: E402
from rustqip_tpu_torch.interop import ops_from_reference, planes_from_numpy, planes_to_numpy  # noqa: E402
from rustqip_tpu_torch.ops.matrix_ops import op_fingerprint  # noqa: E402
from rustqip_tpu_torch.prelude import LocalBuilder  # noqa: E402
from test_torch_planner import _check_plans, _same  # noqa: E402

torch.set_num_threads(1)  # the test runner keeps one worker per core busy

N_MERGE = 19  # tests/test_step_merge.py: row qubits 0-11 are genuine row bits
N_PAIR = 10  # tests/test_sweep_pairing.py
H, X, Y, Z, T = (m.reshape(-1) for m in (gates.H, gates.X, gates.Y, gates.Z, gates.T))


def _u(k, seed):
    r = np.random.default_rng(seed)
    m = r.normal(size=(1 << k, 1 << k)) + 1j * r.normal(size=(1 << k, 1 << k))
    return np.linalg.qr(m)[0].reshape(-1)


def _phase(indices, diag):
    return R.PhaseProductOp(((tuple(indices), tuple(complex(v) for v in diag)),))


def _merge_cases(n=N_MERGE):
    cx = R.make_control_op([0], R.make_matrix_op([n - 1], X))
    ccx = R.make_control_op([0, 1], R.make_matrix_op([n - 1], X))
    cp = _phase([2, n - 1], np.exp(1j * np.pi / 4 * np.arange(4)))
    h0 = R.make_matrix_op([0], H)
    t_ladder = []
    for _ in range(8):
        t_ladder += [R.make_matrix_op([n - 1], T), h0]
    return {
        "merge_hh_cancel": ([h0] * 4, [[]]),
        "merge_t_ladder_cancels": (t_ladder, [[]]),
        "merge_overlap_blocks": ([cx, h0, cx], [[["cbf", "mix", "cbf"]]]),
        "merge_ctrl_butterflies_cancel": (
            [ccx, R.make_matrix_op([n - 2], T), ccx], [[["cbf"]]]),
        "merge_row_mix_cancel": (
            [R.make_matrix_op([0], X), R.make_matrix_op([1], Z), R.make_matrix_op([0], X)],
            [[["mix"]]]),
        "merge_diag_angle_groups": ([cp, h0, cp], [[["diag", "mix"]], [["mix", "diag"]]]),
    }


def _pair_cases(n=N_PAIR):
    xz = np.kron(gates.X, gates.Z).reshape(-1)
    sp = R.make_sparse_matrix_op([1, 5], [[(i ^ 1, 1.0)] for i in range(4)])
    colp = [R.make_matrix_op([n - 1], H), _phase([n - 1, n - 2], (1, 1, 1, 1j)),
            R.make_matrix_op([n - 2], H)]
    Xm = np.array([[0, 1], [1, 0]], dtype=np.complex128)
    return {
        "pair_alternating_and_trailing": [
            R.make_matrix_op([(i % 2) * (n - 1)], H) for i in range(8)
        ] + [R.make_matrix_op([n - 1], H), R.make_matrix_op([0], H)],
        "pair_low_run_and_scalar_high": [
            R.make_matrix_op([0], H), R.make_matrix_op([n - 1], H),
            R.make_matrix_op([n - 2], _u(1, 1)), R.make_matrix_op([n - 1, n - 3], _u(2, 2)),
            R.make_matrix_op([n - 2], T)],
        "pair_two_bit_scalar_high": [
            R.make_matrix_op([0, 2], xz), R.make_matrix_op([n - 1], H),
            R.make_matrix_op([1], H), R.make_matrix_op([0, 2], xz),
            R.make_matrix_op([n - 1], T), R.make_matrix_op([2], H)],
        "pair_unpairable_mix": [
            R.make_matrix_op([0], H), _phase([0, n - 1], (1, 1, 1, -1)),
            R.make_matrix_op([n - 1], H),
            R.make_control_op([0], R.make_matrix_op([n - 1], X)), R.make_matrix_op([1], Y),
            R.make_matrix_op([3, n - 1], _u(2, 4)), R.make_matrix_op([0], H)],
        "pair_col_only_phase": [R.make_matrix_op([0], H)] + colp,
        "pair_multi_bit_window_and_cap": [
            R.make_matrix_op([0], H), R.make_matrix_op([n - 1], T), R.make_matrix_op([1], X),
            R.make_matrix_op([n - 2], _u(1, 7)), R.make_matrix_op([2], Y),
            R.make_matrix_op([0], Z), R.make_matrix_op([n - 1], H),
            R.make_matrix_op([3], H), R.make_matrix_op([n - 1], H)],
        "pair_scalar_high_seam_ops": [
            R.make_matrix_op([0, n - 1], np.kron(Xm, np.eye(2)).reshape(-1)),
            R.make_matrix_op([0, n - 2, n - 1], np.kron(Xm, np.eye(4)).reshape(-1)),
            R.make_matrix_op([1, n - 1], np.kron(np.diag([1, 1j]), np.eye(2)).reshape(-1))],
        "pair_disjoint_straddling_rmix": [
            R.make_matrix_op([0, 4, 5], _u(3, 21)), R.make_matrix_op([1, 6, 7], _u(3, 22))],
        "pair_rmix_cap_and_interleave": [
            R.make_matrix_op([0, 1, 2, 5], _u(4, 31)),
            R.make_matrix_op([0], H), R.make_matrix_op([1, 4, 5], _u(3, 41)),
            R.make_matrix_op([9], T), R.make_control_op([2], R.make_matrix_op([0], X)),
            R.make_matrix_op([1, 8], _u(2, 42))],
        "pair_controlled_seam_and_sparse": [
            R.make_control_op([0], R.make_matrix_op([5], X)),
            R.make_control_op([6], R.make_matrix_op([1], X)),
            R.make_control_op([0, 4], R.make_matrix_op([7], X)),
            R.make_matrix_op([0], H), sp, R.make_matrix_op([n - 1], T)],
    }


def _plain_plans_equal(n, ref_ops):
    """The plain planner (kernel off) entry for entry."""
    ref_plan = ref_ra.plan_sweeps(n, ref_ops, kernel_ok=False)
    port_plan = port_ra.plan_sweeps(n, ops_from_reference(ref_ops), False, TPU_REFERENCE)
    assert [k for k, _, _ in port_plan] == [k for k, _, _ in ref_plan]
    for (_, rp, rrun), (_, pp, prun) in zip(ref_plan, port_plan):
        assert [op_fingerprint(o) for o in prun] == [
            op_fingerprint(o) for o in ops_from_reference(rrun)]
        _same(rp, pp)
    return port_plan


def _run_equal(n, ref_ops, kernel, dtype, atol):
    """The port's planned run equals its op-by-op run."""
    ops = ops_from_reference(ref_ops)
    rng = np.random.default_rng(7)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    v /= np.linalg.norm(v)
    got = planes_to_numpy(*port_ra.apply_ops_ri(
        n, ops, *planes_from_numpy(v, dtype, device="cpu"), kernel_ok=kernel))
    re, im = planes_from_numpy(v, dtype, device="cpu")
    for op in ops:
        re, im = port_ra.apply_op_ri(n, op, re, im)
    np.testing.assert_allclose(got, planes_to_numpy(re, im), atol=atol, rtol=0)


def _steps(plan):
    return [[s[0] for s in p[1]] for k, p, _ in plan if k in ("kwindow", "window")]


@pytest.mark.parametrize("name", sorted(_merge_cases()))
def test_step_merge_plans_like_jax(name):
    ref_ops, want_steps = _merge_cases()[name]
    plan = _check_plans(N_MERGE, ref_ops)
    assert _steps(plan) in want_steps
    _plain_plans_equal(N_MERGE, ref_ops)
    _run_equal(N_MERGE, ref_ops, True, torch.float32, 1e-4)


@pytest.mark.parametrize("name", sorted(_pair_cases()))
def test_sweep_pairing_plans_like_jax(name):
    ref_ops = _pair_cases()[name]
    _check_plans(N_PAIR, ref_ops)
    _plain_plans_equal(N_PAIR, ref_ops)
    _run_equal(N_PAIR, ref_ops, False, torch.float64, 1e-10)


def test_merge_and_window_fuzz():
    """Random circuits: the merge pass on the kernel path (n = 19, 40 ops)
    and the window planner (n = 10, 8 trials of 12 ops) plan like the JAX
    package's and execute like op by op."""
    rng = np.random.default_rng(42)
    one_q = [gates.H, gates.X, gates.Y, gates.Z, gates.T]
    ops = []
    for _ in range(40):
        kind = rng.integers(0, 3)
        if kind == 0:
            g = one_q[int(rng.integers(0, len(one_q)))]
            ops.append(R.make_matrix_op([int(rng.integers(0, N_MERGE))], g.reshape(-1)))
        elif kind == 1:
            qs = rng.choice(N_MERGE, size=3, replace=False)
            ops.append(R.make_control_op([int(qs[0]), int(qs[1])],
                                         R.make_matrix_op([int(qs[2])], X)))
        else:
            qs = rng.choice(N_MERGE, size=2, replace=False)
            ops.append(_phase([int(qs[0]), int(qs[1])], np.exp(1j * rng.normal() * np.arange(4))))
    _check_plans(N_MERGE, ops)
    _run_equal(N_MERGE, ops, True, torch.float32, 3e-4)
    rng = np.random.default_rng(123)
    n = N_PAIR
    for _ in range(8):
        trial = []
        for _ in range(12):
            kind = rng.integers(0, 5)
            a, b = (int(x) for x in rng.choice(n, size=2, replace=False))
            if kind == 0:
                trial.append(R.make_matrix_op([a], _u(1, int(rng.integers(1 << 20)))))
            elif kind == 1:
                trial.append(R.make_matrix_op([a, b], _u(2, int(rng.integers(1 << 20)))))
            elif kind == 2:
                ang = rng.uniform(-3, 3)
                trial.append(_phase([a, b], (1, 1, 1, complex(np.cos(ang), np.sin(ang)))))
            elif kind == 3:
                trial.append(R.make_swap_op([min(a, b)], [max(a, b)]))
            else:
                trial.append(R.make_control_op([a], R.make_matrix_op([b], X)))
        _plain_plans_equal(n, trial)
        _run_equal(n, trial, False, torch.float64, 1e-10)


def test_merge_window_steps_is_pure():
    h = tuple(complex(v) for v in gates.H.reshape(-1))
    steps = [("cbf", 3, h), ("rbf", 1, h), ("cbf", 3, h)]
    orig = list(steps)
    merged = port_ra.merge_window_steps(N_MERGE, steps)
    assert steps == orig
    assert [s[0] for s in merged] == [s[0] for s in ref_ra.merge_window_steps(N_MERGE, orig)]
    assert [s[0] for s in merged] == ["rbf"]


def test_prefix_salvage_plans_two_kernel_windows():
    """A run kernel-inapplicable only through later ops keeps its longest
    applicable prefix as a kernel window (n = 28, host only)."""
    n = 28
    cz = np.diag([1, 1, 1, -1]).astype(complex).reshape(-1)
    cx = R.make_control_op([10], R.make_matrix_op([n - 1], X))
    ops = []
    for _ in range(WINDOW_KERNEL_MAX_LOW + 2):
        ops += [R.make_matrix_op([n - 2, n - 1], cz), cx]
    plan = _check_plans(n, ops)
    assert [k for k, _, _ in plan] == ["kwindow", "kwindow"]
    assert len(plan[0][2]) == 2 * WINDOW_KERNEL_MAX_LOW and len(plan[1][2]) == 4


def test_lane_controlled_ops_are_not_butterfly_kept():
    n = 28
    lane_cnot = R.make_control_op([26], R.make_matrix_op([27], X))
    seam_cnot = R.make_control_op([5], R.make_matrix_op([27], X))
    port_lane, port_seam = ops_from_reference([lane_cnot, seam_cnot])
    assert not port_ra.butterfly_eligible(n, port_lane)
    assert port_ra.butterfly_eligible(n, port_seam)
    chain = ops_from_reference([R.make_matrix_op([25], H), lane_cnot, R.make_matrix_op([25], H)])
    fused = fuse_ops(chain, keep=lambda o: port_ra.butterfly_eligible(n, o))
    assert len(fused) == 1


def _kernel_plan_kinds(build):
    """The sweep kinds a 28-qubit circuit plans to with the kernel path on
    under the reference admission (host only: nothing runs)."""
    b = LocalBuilder(dtype="f32", device="cpu", kernel_ok=True)
    build(b)
    cc = b.compile()
    kinds = []
    for seg in cc.segments:
        if isinstance(seg, list):
            kinds += [k for k, _, _ in port_ra.plan_sweeps(cc.n, seg, True, TPU_REFERENCE)]
        elif isinstance(seg, tuple):
            kinds += [k for k, _, _ in port_ra.plan_sweeps(cc.n, seg[2], True, TPU_REFERENCE)]
    return kinds


def test_28_qubit_plan_budgets():
    """Plan-shape guards of the JAX package at n = 28: H on every qubit in
    exactly 4 kernel windows; the ripple adder and the Grover repeat body
    entirely in kernel windows (the adder in at most 8)."""
    assert _kernel_plan_kinds(lambda b: b.measure(b.h(b.register(28)))) == ["kwindow"] * 4

    def adder(b):
        add(b, b.register(9), b.register(9), b.register(10))

    kinds = _kernel_plan_kinds(adder)
    assert kinds and set(kinds) == {"kwindow"} and len(kinds) <= 8
    kinds = _kernel_plan_kinds(lambda b: grover_search(b, 28, 0x5A5A5A, iterations=3))
    assert kinds and set(kinds) == {"kwindow"}


def test_bench_unfused_shape_one_pass_per_gate():
    """bench.py's unfused arm (Toffolis on rotating row triples) plans one
    sweep per gate at n = 28 and its fused arm one kernel window, as in the
    JAX package; at n = 12 the planned run equals the op-by-op run and the
    JAX package's, in float64 (1e-10) and on the kernel path in float32
    (the kernel's plain version here)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "_bench", Path(__file__).resolve().parent.parent / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    fused, unfused = bench._build_ops(28, 30, 20)
    plan = _check_plans(28, unfused)
    assert len(plan) == 20 and all(len(run) == 1 for _, _, run in plan)
    fplan = _check_plans(28, fused)
    assert [k for k, _, _ in fplan] == ["kwindow"]

    n = 12
    _, small = bench._build_ops(n, 8, 8)
    _run_equal(n, small, False, torch.float64, 1e-10)
    _run_equal(n, small, True, torch.float32, 1e-5)
    rng = np.random.default_rng(0)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    v /= np.linalg.norm(v)
    import jax.numpy as jnp

    jr, ji = ref_ra.apply_ops_ri(n, small, jnp.asarray(v.real), jnp.asarray(v.imag))
    got = planes_to_numpy(*port_ra.apply_ops_ri(
        n, ops_from_reference(small), *planes_from_numpy(v, torch.float64, device="cpu")))
    np.testing.assert_allclose(got, np.asarray(jr) + 1j * np.asarray(ji), atol=1e-10, rtol=0)


def test_prefix_salvage_execution_equivalence():
    """The salvaged-prefix plan (CZ lows alternating with lane-controlled
    rbf butterflies past the low cap, n = 16) plans to two kernel windows
    as in the JAX package and runs them right: the kernel path in float32
    (the kernel's plain version on the CPU) equals the op-by-op run within
    the JAX test's 2e-4."""
    n = 16
    cz = np.diag([1, 1, 1, -1]).astype(complex).reshape(-1)
    cx = R.make_control_op([n - 3], R.make_matrix_op([5], X))  # rbf bit 3, ctrl ("c", 2)
    ops = []
    for _ in range(WINDOW_KERNEL_MAX_LOW + 2):
        ops += [R.make_matrix_op([n - 2, n - 1], cz), cx]
    plan = _check_plans(n, ops)
    assert [k for k, _, _ in plan] == ["kwindow", "kwindow"]
    _run_equal(n, ops, True, torch.float32, 2e-4)
