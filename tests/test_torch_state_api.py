"""The port's state-vector API (``engine.apply_op`` / ``apply_ops`` on flat
complex states) against the JAX package's, case for case with
``tests/test_engine_apply.py``: each op is built once with each package's
constructors from the same data, and both engines get the same seeded
numpy state. Tolerances: 1e-10 in complex128, 1e-6 in complex64 (n <= 5
here), 1e-12 for the host-built matrices. Every call passes
``device="cpu"`` or a CPU tensor: the API's default device is the card.
"""

import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rustqip_tpu.engine import apply as RA  # noqa: E402
from rustqip_tpu.engine.fusion import fuse_ops as ref_fuse_ops  # noqa: E402
from rustqip_tpu.ops import gates as RG  # noqa: E402
from rustqip_tpu.ops import matrix_ops as R  # noqa: E402
from rustqip_tpu.types import Representation as RRep  # noqa: E402

from rustqip_tpu_torch.engine import apply_op, apply_op_add, apply_ops, as_tensor, as_vector, fuse_ops  # noqa: E402
from rustqip_tpu_torch.ops import gates as PG  # noqa: E402
from rustqip_tpu_torch.ops import matrix_ops as P  # noqa: E402
from rustqip_tpu_torch.types import Representation as PRep  # noqa: E402

torch.set_num_threads(1)  # the test runner keeps one worker per core busy

TOL = {np.complex128: 1e-10, np.complex64: 1e-6}
# each package's op constructors, gates and endianness enum
PKGS = ((R, RG, RRep), (P, PG, PRep))


def random_state(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return v / np.linalg.norm(v)


def random_unitary(dim, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim)))
    return q


def kron_at(mat, before, after):
    return np.kron(np.kron(np.eye(1 << before), mat), np.eye(1 << after))


def both(build):
    """(JAX op, port op), each made by ``build(matrix_ops, gates, rep)``."""
    return tuple(build(*pkg) for pkg in PKGS)


def check(n, build, full=None, seed=0):
    """The port's matrix equals the oracle ``full`` (or the JAX package's),
    and its ``apply_op`` equals the JAX package's in both precisions: from
    a numpy state in complex128 and a CPU tensor in complex64."""
    ref_op, op = both(build)
    want_full = R.make_op_matrix(n, ref_op) if full is None else full
    np.testing.assert_allclose(P.make_op_matrix(n, op), want_full, atol=1e-12)
    psi = random_state(n, seed)
    for dt in (np.complex128, np.complex64):
        x = psi.astype(dt)
        want = np.asarray(RA.apply_op(n, ref_op, jnp.asarray(x)))
        got = apply_op(n, op, x, device="cpu") if dt is np.complex128 else \
            apply_op(n, op, torch.as_tensor(x))
        assert got.dtype == (torch.complex128 if dt is np.complex128 else torch.complex64)
        assert got.shape == (1 << n,)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL[dt])
    np.testing.assert_allclose(apply_op(n, op, psi, device="cpu").numpy(), want_full @ psi,
                               atol=1e-10)


@pytest.mark.parametrize("mat", ["I", "X", "H", "nonunitary"])
def test_single_qubit_placements(mat):
    data = {"I": np.eye(2), "X": RG.X, "H": RG.H, "nonunitary": np.array([[1, 2], [3, 4]])}[mat]
    n = 3
    for pos in range(n):
        check(n, lambda M, G, E: M.make_matrix_op([pos], data.astype(np.complex128).reshape(-1)),
              kron_at(data, pos, n - 1 - pos), seed=pos)


def test_two_qubit_adjacent():
    n = 4
    data = np.array([1, 0, 0, 0, 0, 0, 1, 0, 0, 1, 0, 0, 0, 0, 0, 1], dtype=np.complex128)
    check(n, lambda M, G, E: M.make_matrix_op([1, 2], data), kron_at(data.reshape(4, 4), 1, 1))


def test_counting_order_sensitivity():
    # ref matrix_ops.rs:351-374: [0,1] matches row-major data, [1,0] must not
    data = np.arange(16, dtype=np.complex128)
    op = P.make_matrix_op([0, 1], data)
    np.testing.assert_allclose(P.make_op_matrix(2, op), data.reshape(4, 4))
    flipped = P.make_matrix_op([1, 0], data)
    assert not np.allclose(P.make_op_matrix(2, flipped), data.reshape(4, 4))
    np.testing.assert_allclose(P.make_op_matrix(2, flipped),
                               R.make_op_matrix(2, R.make_matrix_op([1, 0], data)), atol=1e-12)
    check(2, lambda M, G, E: M.make_matrix_op([1, 0], data))


def test_two_qubit_nonadjacent_random_unitary():
    u = random_unitary(4, 1)
    check(5, lambda M, G, E: M.make_matrix_op([0, 3], u.reshape(-1)))


def test_swap_op():
    # swapping register halves exchanges the high and low index bits
    full = np.zeros((16, 16))
    for row in range(16):
        full[row, ((row & 0b11) << 2) | (row >> 2)] = 1
    check(4, lambda M, G, E: M.make_swap_op([0, 1], [2, 3]), full)


def test_swap_single_pair():
    full = np.zeros((8, 8))
    for row in range(8):
        b0, b1, b2 = (row >> 2) & 1, (row >> 1) & 1, row & 1
        full[row, (b2 << 2) | (b1 << 1) | b0] = 1
    check(3, lambda M, G, E: M.make_swap_op([0], [2]), full)


def test_control_op():
    cnot_02 = np.eye(8)
    for row in range(4, 8):
        cnot_02[row, row] = 0
        cnot_02[row, row ^ 1] = 1
    check(3, lambda M, G, E: M.make_control_op([0], M.make_matrix_op([2], G.X.reshape(-1))),
          cnot_02)


def test_control_flattening_and_nested():
    def build(M, G, E):
        c1 = M.make_control_op([2], M.make_matrix_op([3], G.X.reshape(-1)))
        return M.make_control_op([0, 1], c1)

    op = both(build)[1]
    assert op.n_ctrl == 3 and op.indices == (0, 1, 2, 3)
    ccx = np.eye(16)
    for row in (14, 15):
        ccx[row, row] = 0
        ccx[row, row ^ 1] = 1
    check(4, build, ccx)


def test_control_of_random_unitary():
    u = random_unitary(4, 2)
    check(4, lambda M, G, E: M.make_control_op([2], M.make_matrix_op([1, 3], u.reshape(-1))))


def test_sparse_big_endian():
    rows = [[(1, 1.0)], [(0, 1.0)]]  # X
    check(3, lambda M, G, E: M.make_sparse_matrix_op([1], rows, E.BigEndian),
          kron_at(RG.X, 1, 1))


def test_sparse_little_endian_normalization():
    # ref matrix_ops.rs:347-377: little-endian input is re-indexed
    u = random_unitary(4, 3)

    def flip2(x):
        return ((x & 1) << 1) | (x >> 1)

    big = [[(c, u[r, c]) for c in range(4)] for r in range(4)]
    little = [[(flip2(c), u[flip2(r), c]) for c in range(4)] for r in range(4)]
    ops_big = both(lambda M, G, E: M.make_sparse_matrix_op([0, 1], big, E.BigEndian))
    ops_little = both(lambda M, G, E: M.make_sparse_matrix_op([0, 1], little, E.LittleEndian))
    np.testing.assert_allclose(P.op_to_dense(ops_little[1]), P.op_to_dense(ops_big[1]),
                               atol=1e-12)
    np.testing.assert_allclose(P.op_to_dense(ops_little[1]), R.op_to_dense(ops_little[0]),
                               atol=1e-12)
    check(2, lambda M, G, E: M.make_sparse_matrix_op([0, 1], little, E.LittleEndian))


def test_sparse_permutation_fast_path():
    rng = np.random.default_rng(4)
    perm = rng.permutation(4)
    phases = np.exp(1j * rng.normal(size=4))
    rows = [[(int(perm[r]), complex(phases[r]))] for r in range(4)]
    ref_op, op = both(lambda M, G, E: M.make_sparse_matrix_op([1, 3], rows))
    assert op.is_permutation() and ref_op.is_permutation()
    check(4, lambda M, G, E: M.make_sparse_matrix_op([1, 3], rows))


def test_sparse_general_scatter():
    u = random_unitary(2, 5)
    rows = [[(c, u[r, c]) for c in range(2)] for r in range(2)]
    ref_op, op = both(lambda M, G, E: M.make_sparse_matrix_op([1], rows))
    assert not op.is_permutation() and not ref_op.is_permutation()
    check(3, lambda M, G, E: M.make_sparse_matrix_op([1], rows), kron_at(u, 1, 1))


def test_apply_ops_sequence_and_fusion():
    n = 5
    u = random_unitary(4, 6)

    def build(M, G, E):
        return [
            M.make_matrix_op([0], G.H.reshape(-1)),
            M.make_control_op([0], M.make_matrix_op([3], G.X.reshape(-1))),
            M.make_matrix_op([2], G.T.reshape(-1)),
            M.make_swap_op([1], [4]),
            M.make_matrix_op([3, 4], u.reshape(-1)),
        ]

    ref_ops, ops = both(build)
    psi = random_state(n, 7)
    expected = psi
    for op in ops:
        expected = P.make_op_matrix(n, op) @ expected
    for cap in (None, 5, 2):  # unfused, then fused at two widths
        rops = ref_ops if cap is None else ref_fuse_ops(ref_ops, max_qubits=cap)
        pops = ops if cap is None else fuse_ops(ops, max_qubits=cap)
        assert len(pops) == len(rops)
        if cap == 5:
            assert len(pops) < len(ops)
        for dt in (np.complex128, np.complex64):
            x = psi.astype(dt)
            got = apply_ops(n, pops, x, device="cpu").numpy()
            np.testing.assert_allclose(got, np.asarray(RA.apply_ops(n, rops, jnp.asarray(x))),
                                       atol=TOL[dt])
            np.testing.assert_allclose(got, expected, atol=TOL[dt])


def test_expand_op_matrix():
    u = random_unitary(2, 8)
    np.testing.assert_allclose(P.expand_op_matrix(u, [1], 3), kron_at(u, 1, 1), atol=1e-12)
    u2 = random_unitary(4, 9)
    np.testing.assert_allclose(P.expand_op_matrix(u2, [0, 2], 3),
                               P.make_op_matrix(3, P.make_matrix_op([0, 2], u2.reshape(-1))),
                               atol=1e-12)
    np.testing.assert_allclose(P.expand_op_matrix(u2, [2, 0], 3), R.expand_op_matrix(u2, [2, 0], 3),
                               atol=1e-12)


def test_apply_op_leaves_input_unchanged():
    """Every op kind, on a CPU tensor and a numpy array, in both
    precisions: the input is bit-equal afterwards and the output is a new
    tensor."""
    n = 9
    u = random_unitary(4, 10)
    ops = [
        P.make_matrix_op([7, 8], u.reshape(-1)),  # lane qubits
        P.make_matrix_op([0, 5], u.reshape(-1)),  # row qubits
        P.make_swap_op([0, 1, 7], [3, 4, 2]),     # row, mixed and cross pairs
        P.make_control_op([8], P.make_swap_op([0], [1])),
        P.make_reflection_op([1, 8]),
    ]
    for dt in (np.complex128, np.complex64):
        psi = random_state(n, 11).astype(dt)
        keep = psi.copy()
        t = torch.as_tensor(psi.copy())
        t_keep = t.clone()
        for op in ops:
            out = apply_op(n, op, t)
            assert out.data_ptr() != t.data_ptr()
            apply_op(n, op, psi, device="cpu")
        out = apply_ops(n, ops, t)
        apply_ops(n, ops, psi, device="cpu")
        assert torch.equal(t, t_keep) and np.array_equal(psi, keep)
        assert out.data_ptr() != t.data_ptr()


def test_numpy_input_without_device_raises_on_a_host_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default device exists")
    psi = random_state(3, 12)
    op = P.make_matrix_op([0], PG.H.reshape(-1))
    for call in (lambda: apply_op(3, op, psi), lambda: apply_ops(3, [op], psi)):
        with pytest.raises((AssertionError, RuntimeError)):
            call()
    with pytest.raises(ValueError):
        apply_op(4, op, psi, device="cpu")  # 8 amplitudes are not 4 qubits


def test_views_add_and_real_input():
    """``as_vector`` / ``as_tensor`` are views with the JAX package's
    shapes; ``apply_op_add`` is ``acc + op @ state``; a real state is
    promoted to complex."""
    n = 4
    psi = random_state(n, 13)
    t = torch.as_tensor(psi)
    ten = as_tensor(t, n)
    assert ten.shape == (2,) * n and ten.data_ptr() == t.data_ptr()
    np.testing.assert_array_equal(ten.numpy(), np.asarray(RA.as_tensor(jnp.asarray(psi), n)))
    assert torch.equal(as_vector(ten), t)
    u = random_unitary(4, 14)
    ref_op, op = both(lambda M, G, E: M.make_matrix_op([1, 2], u.reshape(-1)))
    acc = random_state(n, 15)
    got = apply_op_add(n, op, psi, acc, device="cpu").numpy()
    np.testing.assert_allclose(
        got, np.asarray(RA.apply_op_add(n, ref_op, jnp.asarray(psi), jnp.asarray(acc))),
        atol=1e-10)
    # a real state is promoted to complex (the JAX package's CPU path would
    # cast the gate to the state's real dtype instead)
    real = np.random.default_rng(16).normal(size=1 << n)
    got = apply_op(n, op, torch.as_tensor(real))
    assert got.dtype == torch.complex128
    np.testing.assert_allclose(
        got.numpy(), np.asarray(RA.apply_op(n, ref_op, jnp.asarray(real + 0j))), atol=1e-10)


def test_is_permutation_and_select_matrix_coords_match_reference():
    rows_perm = [[(2, 1j)], [(0, 1.0)], [(3, -1.0)], [(1, 1.0)]]
    rows_mix = [[(0, 0.6), (1, 0.8)], [(0, 0.8), (1, -0.6)], [(2, 1.0)], [(3, 1.0)]]
    for rows in (rows_perm, rows_mix):
        ref_op, op = both(lambda M, G, E: M.make_sparse_matrix_op([0, 2], rows))
        assert op.is_permutation() == ref_op.is_permutation()
    n = 5
    for indices in ([0], [1, 3], [4, 0, 2]):
        for row in range(0, 1 << n, 3):
            for col in range(0, 1 << n, 5):
                assert P.select_matrix_coords(n, indices, row, col) == \
                    R.select_matrix_coords(n, indices, row, col)


def test_engine_package_exports_in_a_fresh_interpreter():
    """``rustqip_tpu_torch.engine`` imported first, alone, exports the JAX
    package's L0 names (no import cycle through ``compile`` or the
    measurement module), and the ops and builder packages theirs."""
    code = (
        "import rustqip_tpu_torch.engine as e, sys\n"
        "names = ['apply_op', 'apply_ops', 'apply_op_add', 'as_tensor', 'as_vector',"
        " 'fuse_ops', 'CompiledCircuit', 'compile_pipeline']\n"
        "assert all(callable(getattr(e, k)) for k in names)\n"
        "assert set(names) <= set(e.__all__)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'rustqip_tpu.'))"
        " for m in sys.modules)\n"
        "import rustqip_tpu_torch.ops as o, rustqip_tpu_torch.builder as b\n"
        "assert {'prob_magnitude', 'measure_probs', 'measure_state', 'measure'} <= set(o.__all__)\n"
        "assert {'CircuitObject', 'UnitaryObject', 'NamedGate', 'RzGate', 'MatGate',"
        " 'ControlledMatGate', 'GlobalPhaseGate', 'MeasurementObject',"
        " 'invert_circuit_object'} <= set(b.__all__)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
