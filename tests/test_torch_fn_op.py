"""Function ops (``FnOp`` / ``FnGate``) in the port against the JAX
package: the dense embedding (plain, diagonal, conjugated, XOR oracle),
the gather and diagonal passes, the builder surfaces (``apply_function_op``,
``apply_fn_matrix``, conditioned), ``FnGate`` inversion, swap relabeling,
fusion and the planner.

The oracles are written once and run in both packages: ``_phase`` and
``_where`` pick torch or jax.numpy by their argument, and the index
arithmetic uses operators both take. Tolerances: 1e-10 in f64 and c128
(BASELINE.md row 3), 1e-5 in f32.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rustqip_tpu.engine.real_apply import apply_ops_ri as ref_apply_ops  # noqa: E402
from rustqip_tpu.engine.real_apply import plan_sweeps as ref_plan_sweeps  # noqa: E402
from rustqip_tpu.ops import gates as rgates  # noqa: E402
from rustqip_tpu.ops import matrix_ops as R  # noqa: E402

from rustqip_tpu_torch.builder.circuit_objects import (  # noqa: E402
    CircuitObject,
    ControlledMatGate,
    FnGate,
    invert_circuit_object,
)
from rustqip_tpu_torch.engine.admission import TpuReferenceAdmission  # noqa: E402
from rustqip_tpu_torch.engine.fusion import fuse_ops  # noqa: E402
from rustqip_tpu_torch.engine.real_apply import apply_ops_ri, plan_sweeps  # noqa: E402
from rustqip_tpu_torch.errors import CircuitError  # noqa: E402
from rustqip_tpu_torch.interop import (  # noqa: E402
    op_from_reference,
    ops_from_reference,
    planes_from_numpy,
    planes_to_numpy,
)
from rustqip_tpu_torch.ops import gates  # noqa: E402
from rustqip_tpu_torch.ops import matrix_ops as P  # noqa: E402

torch.set_num_threads(1)  # the test runner keeps one worker per core busy

F64, F32 = 1e-10, 1e-5


def _phase(a, theta):
    """exp(i theta a) in complex128, for torch tensors and jax arrays."""
    if isinstance(a, torch.Tensor):
        return torch.polar(torch.ones(a.shape, dtype=torch.float64, device=a.device),
                           theta * a.to(torch.float64))
    return jnp.exp(1j * theta * jnp.asarray(a, jnp.float64))


def _where(c, a, b):
    return torch.where(c, a, b) if isinstance(c, torch.Tensor) else jnp.where(c, a, b)


def _phase_perm(row):
    """An affine permutation of 5 bits with a nontrivial phase."""
    return (row * 5 + 3) % 32, _phase(row, 0.7)


def _phases(row):
    return row, _phase(row, 0.37)


def _xor_f(x):
    return (3 * x + 1) % 8, _phase(x, 0.3)


def _state(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return v / np.linalg.norm(v)


def _ref_run(n, ops, v):
    re, im = ref_apply_ops(n, ops, jnp.asarray(v.real), jnp.asarray(v.imag))
    return np.asarray(re) + 1j * np.asarray(im)


def _port_run(n, ops, v, dtype=torch.float64):
    return planes_to_numpy(*apply_ops_ri(n, ops, *planes_from_numpy(v, dtype=dtype, device="cpu")))


def _op_cases():
    """(n, reference op): the general gather on unsorted mixed row/lane
    qubits, a diagonal op and its conjugate, an XOR oracle and its
    inverse, and a controlled op wider than DENSE_CAP."""
    diag = R.make_fn_op([1, 4, 8], _phases, diagonal=True)
    xor = R.make_function_op([0, 1, 2], [3, 4, 5], _xor_f)
    wide = R.make_function_op([2, 3, 4, 5, 6, 7], [8, 9, 10, 11, 1], _xor_f)
    return {
        "general": (12, R.make_fn_op([0, 7, 3, 10, 11], _phase_perm)),
        "diagonal": (10, diag),
        "diagonal_conj": (10, R.conj_op(diag)),
        "xor": (8, xor),
        "xor_inverse": (8, R.invert_op(xor)),
        "controlled_wide": (12, R.make_control_op([0], wide)),
    }


OP_CASES = _op_cases()


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_fn_op_dense_and_apply_match_reference(name):
    """The port's dense embedding equals the JAX package's, and its apply
    (gather, diagonal multiply, or controlled on plane copies) equals the
    JAX package's apply on the same state and the dense form's."""
    n, ref_op = OP_CASES[name]
    op = op_from_reference(ref_op)
    assert P.op_fingerprint(op) == R.op_fingerprint(ref_op)
    if op.num_indices <= 10:
        U = P.op_to_dense(op)
        np.testing.assert_allclose(U, R.op_to_dense(ref_op), atol=1e-12)
        assert np.abs(U @ U.conj().T - np.eye(U.shape[0])).max() < 1e-12
    v = _state(n, 3)
    got = _port_run(n, [op], v)
    assert np.abs(got - _ref_run(n, [ref_op], v)).max() <= F64
    if op.num_indices <= 10:
        dense = P.DenseOp(tuple(op.indices), P.op_to_dense(op))
        assert np.abs(got - _port_run(n, [dense], v)).max() <= F64


def test_diagonal_fn_op_equals_its_gather_form():
    """diagonal=True (no gather) agrees with the same fn as a general op."""
    n = 10
    v = _state(n, 4)
    diag = P.make_fn_op([1, 4, 8], _phases, diagonal=True)
    assert diag.diagonal and diag.self_transpose
    general = P.make_fn_op([1, 4, 8], _phases)
    assert np.abs(_port_run(n, [diag], v) - _port_run(n, [general], v)).max() <= 1e-12


def test_wide_fn_oracle_single_pass():
    """An 18-qubit XOR permutation inside n = 20 — far beyond any table
    cap: a basis state maps to the XOR-shifted basis state exactly."""
    n, k = 20, 18
    op = P.make_fn_op(list(range(k)), lambda row: (row ^ 0x2A5A5, 1))
    s = np.zeros(1 << n)
    s[12345] = 1.0
    got = _port_run(n, [op], s, torch.float32)
    nz = np.nonzero(got)[0]
    assert list(nz) == [12345 ^ (0x2A5A5 << 2)] and got[nz[0]] == 1.0


def test_function_op_xor_semantics_and_invert():
    """|x>|y> -> theta(x)|x>|y ^ f(x)> (qubit_iterators.rs:232-253),
    inverted by the elementwise conjugate; a general op cannot transpose."""
    from rustqip_tpu_torch.utils.bits import flip_bits

    op = P.make_function_op([0, 1, 2], [3, 4, 5], _xor_f)
    U = P.op_to_dense(op)
    for x in range(8):
        for y in range(8):
            # register values are little-endian across the qubit list
            row = (flip_bits(3, x) << 3) | flip_bits(3, y)
            col = (flip_bits(3, x) << 3) | flip_bits(3, y ^ (3 * x + 1) % 8)
            assert abs(U[row, col] - np.exp(0.3j * x)) < 1e-12, (x, y)
    Uinv = P.op_to_dense(P.invert_op(op))
    assert np.abs(Uinv @ U - np.eye(64)).max() < 1e-12
    with pytest.raises(CircuitError):
        P.transpose_op(P.make_fn_op([0, 1], lambda r: ((r + 1) % 4, 1)))
    with pytest.raises(CircuitError, match="31"):
        P.make_fn_op(range(32), lambda r: (r, 1))


def _build_xor(b, cond):
    rx, ry = b.register(3), b.register(3)
    rx = b.h(rx)
    if cond:
        c = b.h(b.qubit())
        cb = b.condition_with(c)
        if hasattr(cb, "apply_function_op"):
            rx, ry = cb.apply_function_op(rx, ry, _xor_f)
        else:  # the JAX package has it on LocalBuilder alone
            xor = R.make_function_op(range(3), range(3, 6), _xor_f)
            cb.apply_fn_matrix(cb.merge_two_registers(rx, ry), xor.fn, self_transpose=True)
        cb.dissolve()
    else:
        rx, ry = b.apply_function_op(rx, ry, _xor_f)


def _build_fn_matrix_f32(b, cond):
    r = b.h(b.register(4))
    b.apply_fn_matrix(r, lambda row: ((row + 5) % 16, _phase(row, 0.25)), tag="add5")


def _mulmod(row):
    return _where(row < 15, (7 * row) % 15, row), 1.0


def _build_conditioned(b, cond):
    """cb.apply_fn_matrix: a controlled modular multiplication."""
    c = b.h(b.qubit())
    qs = b.split_all_register(b.register(4))
    qs[0] = b.x(qs[0])  # |y = 1>
    y = b.merge_registers(qs)
    cb = b.condition_with(c)
    cb.apply_fn_matrix(y, _mulmod, tag="mul7mod15")
    cb.dissolve()


def _build_swap_deferral(b, cond):
    """Swaps recorded before the oracle commute through it (relabeling)."""
    qs = b.split_all_register(b.register(5))
    qs[0], qs[3] = b.swap(qs[0], qs[3])
    qs[1] = b.h(qs[1])
    tgt = b.merge_registers([qs[0], qs[2], qs[4]])
    b.apply_fn_matrix(tgt, lambda row: ((row * 3 + 1) % 8, _phase(row, 0.4)))


BUILDS = {
    "apply_function_op": (_build_xor, False, "c128", F64),
    "apply_function_op_conditioned": (_build_xor, True, "c128", F64),
    "apply_fn_matrix_f32": (_build_fn_matrix_f32, False, "f32", F32),
    "apply_fn_matrix_conditioned": (_build_conditioned, False, "c128", F64),
    "swap_deferral": (_build_swap_deferral, False, "c128", F64),
}


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_builder_surfaces_match_reference(name):
    """The same builder calls on both packages give the same state, and
    the port's matches its own table path (each FnGate densified)."""
    from rustqip_tpu.prelude import LocalBuilder as RB

    from rustqip_tpu_torch.builder import builder as pb
    from rustqip_tpu_torch.prelude import LocalBuilder as PB

    build, cond, dtype, tol = BUILDS[name]
    rb = RB(dtype=dtype)
    build(rb, cond)
    want = np.asarray(rb.calculate_state(seed=0)[0]).astype(np.complex128)
    b = PB(dtype=dtype, device="cpu")
    build(b, cond)
    assert any(isinstance(co.obj, (FnGate, ControlledMatGate)) for _, co in b.pipeline)
    got = np.asarray(b.calculate_state(seed=0)[0]).astype(np.complex128)
    assert np.abs(got - want).max() <= tol

    # the table path: every function op of the lowered circuit densified
    from rustqip_tpu_torch.engine.compile import UnitaryEntry, compile_pipeline

    entries = [
        UnitaryEntry(P.DenseOp(tuple(e.op.indices), P.op_to_dense(e.op)))
        if isinstance(e.op, (P.FnOp, P.ControlOp)) else e
        for item in b.pipeline for e in pb._lower_item(item)
    ]

    cc = compile_pipeline(b.n, entries, b.dtype, device="cpu")
    table, _ = cc.run_complex(initial_index=0, generator=torch.Generator().manual_seed(0))
    assert np.abs(got - np.asarray(table).astype(np.complex128)).max() <= tol


def test_fn_gate_inversion_rules():
    """XOR gates invert by conjugation (also under a control); a general
    function gate refuses, as in the JAX package; an inverted circuit
    undoes the oracle."""
    from rustqip_tpu.builder import circuit_objects as rco

    op = P.make_function_op([0, 1, 2], [3, 4, 5], _xor_f)
    (inv,) = invert_circuit_object(CircuitObject(6, FnGate(6, op.fn, op.tag, False, True)))
    (rinv,) = rco.invert_circuit_object(
        rco.CircuitObject(6, rco.FnGate(6, op.fn, op.tag, False, True)))
    assert inv.obj.fingerprint() == rinv.obj.fingerprint()
    assert inv.obj.conjugated and inv.obj.self_transpose
    (cinv,) = invert_circuit_object(
        CircuitObject(7, ControlledMatGate(1, FnGate(6, op.fn, op.tag, False, True))))
    assert cinv.obj.mat.conjugated and cinv.obj.mat.self_transpose
    with pytest.raises(CircuitError):
        invert_circuit_object(CircuitObject(2, FnGate(2, lambda r: ((r + 1) % 4, 1), "rot4")))

    from rustqip_tpu_torch.prelude import LocalBuilder, inverter

    def oracle(b, rx, ry):
        rx = b.h(rx)
        return b.apply_function_op(rx, ry, _xor_f)

    b = LocalBuilder(dtype="c128", device="cpu")
    rx, ry = b.register(3), b.register(3)
    rx, ry = oracle(b, rx, ry)
    rx, ry = inverter(b, [rx, ry], oracle)
    state = np.asarray(b.calculate_state_with_init([(ry, 5)])[0])
    assert abs(abs(state[b.initial_index([(ry, 5)])]) - 1) < 1e-12


def test_fn_op_survives_relabel_and_is_never_fused():
    from rustqip_tpu_torch.engine.relabel import remap_op

    op = P.make_fn_op([0, 1], lambda r: (r ^ 3, 1), tag="x3")
    moved = remap_op(op, [2, 0, 1])
    assert isinstance(moved, P.FnOp) and moved.indices == (2, 0)
    assert moved.fn is op.fn and moved.tag == "x3"
    H = gates.H.reshape(-1)
    fused = fuse_ops([P.make_matrix_op([0], H), op, P.make_matrix_op([0], H)])
    assert [type(o).__name__ for o in fused] == ["DenseOp", "FnOp", "DenseOp"]


def test_plans_with_fn_ops_match_reference():
    """Under TpuReferenceAdmission the port plans a run holding function
    ops (bare, diagonal, controlled narrow and wide) as the JAX package
    does on its kernel path: the same sweep kinds, runs and windows."""
    n = 16
    H = rgates.H.reshape(-1)
    ref_ops = (
        [R.make_matrix_op([q], H) for q in (0, 3, 9, 14)]
        + [R.make_fn_op([0, 7, 3, 10, 11], _phase_perm),
           R.make_fn_op(list(range(16)), _phases, diagonal=True),
           R.make_matrix_op([2], H),
           R.make_control_op([1], R.make_function_op([4], [5, 6], _xor_f)),
           R.make_control_op([0], R.make_function_op(range(1, 8), range(8, 14), _xor_f))]
        + [R.make_matrix_op([q], H) for q in (1, 12)]
    )
    ref_plan = ref_plan_sweeps(n, ref_ops, kernel_ok=True)
    plan = plan_sweeps(n, ops_from_reference(ref_ops), kernel_ok=True,
                       admission=TpuReferenceAdmission())
    assert [k for k, _, _ in plan] == [k for k, _, _ in ref_plan]
    assert "kwindow" in {k for k, _, _ in plan}
    for (rk, rp, rrun), (k, p, run) in zip(ref_plan, plan):
        assert [P.op_fingerprint(o) for o in run] == [
            P.op_fingerprint(o) for o in ops_from_reference(rrun)]
        if k != "op":
            assert tuple(p[0]) == tuple(rp[0])
            assert [s[0] for s in p[1]] == [s[0] for s in rp[1]]
