"""The port's explicit shard path (``parallel/shard_ops.apply_sharded_ops``)
against the JAX package's single-device engine: the cases of
``tests/test_shard_ops.py`` (every schedule entry kind, the chunked exchange,
the generalized-permutation exchange of wide function and sparse ops, both
its gather and XOR-flip recombinations, the three reflections, repeats) on
meshes of D = 2, 4 and 8 entries of ``"cpu"``. The seeded state goes through
the JAX package on one device and through the port's shards;
1e-10 in float64, 1e-5 in float32."""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from rustqip_tpu.engine.apply import apply_op as ref_apply  # noqa: E402
from rustqip_tpu.ops import gates  # noqa: E402
from rustqip_tpu.ops import matrix_ops as R  # noqa: E402

from rustqip_tpu_torch.engine.admission import TPU_REFERENCE  # noqa: E402
from rustqip_tpu_torch.engine.real_apply import plan_sweeps  # noqa: E402
from rustqip_tpu_torch.interop import ops_from_reference  # noqa: E402
from rustqip_tpu_torch.parallel import make_shard_mesh  # noqa: E402
from rustqip_tpu_torch.parallel.explicit import gather_state  # noqa: E402
from rustqip_tpu_torch.parallel.shard_ops import (  # noqa: E402
    _lower_schedule,
    apply_sharded_op,
    apply_sharded_ops,
    compile_sharded_ops,
    make_sharded_pair,
)

torch.set_num_threads(1)  # the test runner keeps one worker per core busy

N = 7  # on 8 shards: 3 global qubits, 4 local
TOL = {np.float64: 1e-10, np.float32: 1e-5}
H, X, Y, Z, T = (m.reshape(-1) for m in (gates.H, gates.X, gates.Y, gates.Z, gates.T))


def _u(k, seed):
    r = np.random.default_rng(seed)
    m = r.normal(size=(1 << k, 1 << k)) + 1j * r.normal(size=(1 << k, 1 << k))
    return np.linalg.qr(m)[0].reshape(-1)


def _mesh(d):
    return make_shard_mesh(d, devices=["cpu"] * d)


def _want(n, ops, init, times=1):
    """The JAX package's single-device state after ``ops`` (``times`` over):
    up to 8 qubits through its full op matrices (``make_op_matrix``, no jit
    compile per op), above through its engine's ``apply_op``."""
    state = np.zeros(1 << n, dtype=np.complex128)
    state[init] = 1.0
    for _ in range(times):
        for op in ops:
            if n <= 8:
                state = R.make_op_matrix(n, op) @ state
            else:
                state = np.asarray(ref_apply(n, op, state))
    return state


def _got(d, n, ops, init, dtype=np.float64, **kw):
    mesh = _mesh(d)
    re, im = make_sharded_pair(mesh, n, initial_index=init, dtype=dtype)
    re, im = apply_sharded_ops(mesh, n, ops_from_reference(ops), re, im, **kw)
    return gather_state(re, im)


# a superposition first, so that phases matter (tests/test_shard_ops.py)
SEED_OPS = [R.make_matrix_op([3], H), R.make_matrix_op([5], T)]


def _xor_oracle(row):
    return row ^ (((row >> 2) * 5 + 1) & 3), 1.0


def _phase_oracle(row):
    return row, 1.0 - 2.0 * ((row % 5) == 2)


CASES = {  # name -> ops, applied in turn after SEED_OPS
    "local": [R.make_matrix_op([4, 6], np.kron(gates.H, gates.X).reshape(-1))],
    "global_single": [R.make_matrix_op([1], H), R.make_matrix_op([0], Y)],
    "global_local_dense": [R.make_matrix_op([2, 5], _u(2, 3))],
    "swaps": [R.make_swap_op([1], [6]), R.make_swap_op([0], [2])],
    "global_controls": [R.make_control_op([0, 2], R.make_matrix_op([5], X)),
                        R.make_control_op([1, 4], R.make_matrix_op([6], Z))],
    "global_targets": [R.make_control_op([5], R.make_matrix_op([1], X)),
                       R.make_control_op([0], R.make_matrix_op([2], Y))],
    "two_global_dense": [R.make_matrix_op([0, 1], gates.CNOT.reshape(-1))],
    "three_global_dense": [R.make_matrix_op([0, 1, 2], _u(3, 9))],
    "phase_product": [R.PhaseProductOp((
        ((0, 5), tuple(complex(v) for v in np.exp(1j * np.linspace(-3, 3, 4)))),
        ((2, 1, 6), tuple(complex(v) for v in np.exp(1j * np.linspace(-2, 2.5, 8)))),
    ))],
    "full_width_dense": [R.make_matrix_op(list(range(N)), _u(N, 1))],
    "coalesced_swap": [R.make_swap_op([0, 1, 2], [6, 5, 4])],
    "wide_sparse": [R.make_sparse_matrix_op(
        list(range(N)),
        [[(int(p), complex(np.exp(0.3j * i)))] for i, p in
         enumerate(np.random.default_rng(3).permutation(1 << N))])],
    "gex_fn": [R.make_fn_op(list(range(N)), _xor_oracle, tag="xor7", self_transpose=True),
               R.make_control_op([0], R.make_fn_op(
                   list(range(1, N)), _xor_oracle, tag="cxor6", self_transpose=True))],
    "fndiag": [R.make_fn_op(list(range(N)), _phase_oracle, tag="ph7", diagonal=True),
               R.make_control_op([N - 1], R.make_fn_op(
                   [0, 1, 4], _phase_oracle, tag="cph3", diagonal=True))],
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_op_matches_jax_single_device(name):
    ops = SEED_OPS + CASES[name]
    want = _want(N, ops, 5)
    for d in (2, 4, 8):
        np.testing.assert_allclose(_got(d, N, ops, 5), want, atol=1e-10, rtol=0)


def test_whole_sequence_and_float32():
    """One schedule for a mixed sequence (locals batch between exchanges),
    in f64 and f32, and ``apply_sharded_op`` one op at a time."""
    ops = [
        R.make_matrix_op([4], H), R.make_matrix_op([0], H), R.make_matrix_op([5], T),
        R.make_matrix_op([6], X), R.make_control_op([1], R.make_matrix_op([3], X)),
        R.make_matrix_op([2, 5], _u(2, 21)), R.PhaseProductOp((((0, 6), (1, 1, 1, 1j)),)),
        R.make_swap_op([1], [4]), R.make_control_op([5], R.make_matrix_op([0], Y)),
    ]
    want = _want(N, ops, 3)
    for d in (2, 4, 8):
        for dt in (np.float64, np.float32):
            np.testing.assert_allclose(_got(d, N, ops, 3, dt), want, atol=TOL[dt], rtol=0)
    mesh = _mesh(8)
    re, im = make_sharded_pair(mesh, N, initial_index=3, dtype=np.float64)
    for op in ops_from_reference(ops):
        re, im = apply_sharded_op(mesh, N, op, re, im)
    np.testing.assert_allclose(gather_state(re, im), want, atol=1e-10, rtol=0)
    assert [e[0] for e in _lower_schedule(N, 3, ops_from_reference(ops[:2]))] == \
        ["local", "exchange"]


def test_chunked_exchange_is_bit_equal_and_falls_back():
    """``chunks=4`` splits each single-global exchange along the top local
    qubits: bit-equal to the whole-shard exchange; an op whose local
    support touches those qubits falls back (still right)."""
    ops = [R.make_matrix_op([4], H), R.make_matrix_op([1], _u(1, 9)),
           R.make_matrix_op([0], H), R.make_matrix_op([6], T), R.make_matrix_op([2], Y)]
    mesh = _mesh(8)
    port_ops = ops_from_reference(ops)
    r1, i1 = apply_sharded_ops(mesh, N, port_ops, *make_sharded_pair(mesh, N, 5, np.float64),
                               chunks=1)
    r4, i4 = apply_sharded_ops(mesh, N, port_ops, *make_sharded_pair(mesh, N, 5, np.float64),
                               chunks=4)
    for a, b in zip(r1 + i1, r4 + i4):
        assert torch.equal(a, b)
    np.testing.assert_allclose(gather_state(r4, i4), _want(N, ops, 5), atol=1e-12, rtol=0)
    op = R.make_matrix_op([1, 3], _u(2, 11))  # local qubit 3 is the top local qubit
    sched = compile_sharded_ops(mesh, N, ops_from_reference([op]), chunks=4)
    assert sched.steps[0][3] is None  # no chunked blocks: the whole shard
    np.testing.assert_allclose(_got(8, N, [op], 2, chunks=4), _want(N, [op], 2), atol=1e-12,
                               rtol=0)


def test_gex_flip_recombination():
    """Globals outnumber the free local slots and the oracle touches 3
    local bits: ``gex`` recombines by XOR-flip reads (n = g + 5)."""
    n = 8
    fop = R.make_fn_op(list(range(6)), lambda row: (row ^ 0b110101, 1.0), tag="flip",
                       self_transpose=True)
    ops = [R.make_matrix_op([q], H) for q in range(0, n, 2)] + [fop]
    sched = compile_sharded_ops(_mesh(8), n, ops_from_reference(ops))
    assert [s[0] for s in sched.steps][-1] == "gex" and sched.steps[-1][-1]  # flip
    np.testing.assert_allclose(_got(8, n, ops, 1), _want(n, ops, 1), atol=1e-12, rtol=0)


def test_gex_wide_sparse_gather():
    """A sparse op wider than DENSE_CAP on every qubit of an 11-qubit state
    (8 local bits: the gather recombination), with complex values."""
    n = 11
    perm = np.random.default_rng(5).permutation(1 << n)
    rows = [[(int(perm[i]), complex(np.exp(0.01j * i)))] for i in range(1 << n)]
    op = R.make_sparse_matrix_op(list(range(n)), rows)
    ops = [R.make_matrix_op([0], H), R.make_matrix_op([n - 1], H), op]
    for d in (2, 8):
        sched = compile_sharded_ops(_mesh(d), n, ops_from_reference(ops))
        assert sched.steps[-1][0] == "gex" and not sched.steps[-1][-1]  # gather
        np.testing.assert_allclose(_got(d, n, ops, 9), _want(n, ops, 9), atol=1e-10, rtol=0)


def test_reflections_full_grouped_controlled():
    ops = [R.make_matrix_op([0], H), R.make_matrix_op([N - 1], H), R.make_matrix_op([2], _u(1, 4)),
           R.make_reflection_op(range(N)), R.make_reflection_op([1, N - 1]),
           R.make_control_op([N - 1], R.make_reflection_op([0, 2])),
           R.make_control_op([0, 3], R.make_reflection_op([1, 5, 6]))]
    kinds = [e[0] for e in _lower_schedule(N, 3, ops_from_reference(ops[3:]))]
    assert kinds == ["reflect"] * 4
    want = _want(N, ops, 1)
    for d in (2, 4, 8):
        np.testing.assert_allclose(_got(d, N, ops, 1), want, atol=1e-10, rtol=0)


def test_repeat_times():
    """``times`` repeats the whole schedule (the JAX package's fori_loop)."""
    ops = [R.make_matrix_op([0], H), R.make_matrix_op([N - 1], T), R.make_matrix_op([0], H),
           R.make_control_op([1], R.make_matrix_op([N - 2], _u(1, 7)))]
    for d in (2, 8):
        np.testing.assert_allclose(_got(d, N, ops, 3, times=6), _want(N, ops, 3, times=6),
                                   atol=1e-10, rtol=0)


def test_local_runs_take_kernel_windows_on_cpu_shards():
    """With ``kernel_ok`` the shard-local run plans kernel windows in the
    local qubit space (R = 64 local rows at n = 16 on 8 shards) and runs
    them through the kernel's plain version here; f32 within 1e-5."""
    n, g = 16, 3
    ops = [R.make_matrix_op([g], H), R.make_matrix_op([n - 1], H),
           R.make_matrix_op([g], H), R.make_matrix_op([n - 1], T),
           R.make_matrix_op([0], H)]
    local = ops_from_reference([R.make_matrix_op([q - g for q in op.indices], op.data)
                                for op in ops[:4]])
    assert "kwindow" in {k for k, _, _ in plan_sweeps(n - g, local, True, TPU_REFERENCE)}
    sched = compile_sharded_ops(_mesh(8), n, ops_from_reference(ops), kernel_ok=True)
    assert sched.sweep_counts()["kwindow"] >= 8
    np.testing.assert_allclose(_got(8, n, ops, 1, np.float32, kernel_ok=True),
                               _want(n, ops, 1), atol=1e-5, rtol=0)
