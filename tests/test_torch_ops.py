"""The port's op IR against the JAX package's: every constructor and the
op algebra materialize to the same dense matrices (exact: both are the same
numpy arithmetic)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from rustqip_tpu.ops import gates as rgates  # noqa: E402
from rustqip_tpu.ops import matrix_ops as R  # noqa: E402
from rustqip_tpu.types import Representation as RRep  # noqa: E402

from rustqip_tpu_torch.interop import op_from_reference  # noqa: E402
from rustqip_tpu_torch.ops import gates as pgates  # noqa: E402
from rustqip_tpu_torch.ops import matrix_ops as P  # noqa: E402
from rustqip_tpu_torch.types import PiRational, Representation  # noqa: E402

torch.set_num_threads(1)  # the test runner keeps one worker per core busy


def _rand_u(k, seed):
    r = np.random.default_rng(seed)
    m = r.normal(size=(1 << k, 1 << k)) + 1j * r.normal(size=(1 << k, 1 << k))
    return np.linalg.qr(m)[0]


def _sparse_rows(k, seed):
    r = np.random.default_rng(seed)
    perm = r.permutation(1 << k)
    ph = np.exp(1j * r.uniform(0, 2 * np.pi, size=1 << k))
    return [[(int(perm[i]), complex(ph[i]))] for i in range(1 << k)]


def _pairs():
    """(reference op, port op) built by the two packages' constructors."""
    u2 = _rand_u(2, 1).reshape(-1)
    u1 = _rand_u(1, 2).reshape(-1)
    rows = _sparse_rows(3, 3)
    cp = ((1, 4), (1, 1, 1, complex(np.cos(0.3), np.sin(0.3))))
    tz = ((2,), (complex(np.exp(-0.2j)), complex(np.exp(0.2j))))
    return [
        ("dense", R.make_matrix_op([3, 1], u2), P.make_matrix_op([3, 1], u2)),
        ("sparse_be", R.make_sparse_matrix_op([0, 2, 5], rows),
         P.make_sparse_matrix_op([0, 2, 5], rows)),
        ("sparse_le", R.make_sparse_matrix_op([0, 2, 5], rows, RRep.LittleEndian),
         P.make_sparse_matrix_op([0, 2, 5], rows, Representation.LittleEndian)),
        ("swap", R.make_swap_op([0, 1], [4, 2]), P.make_swap_op([0, 1], [4, 2])),
        ("control", R.make_control_op([2], R.make_control_op([5], R.make_matrix_op([0], u1))),
         P.make_control_op([2], P.make_control_op([5], P.make_matrix_op([0], u1)))),
        ("phase_product", R.PhaseProductOp((cp, tz)), P.PhaseProductOp((cp, tz))),
        ("reflection", R.make_reflection_op([4, 0, 2]), P.make_reflection_op([4, 0, 2])),
        ("controlled_reflection",
         R.make_control_op([1], R.make_reflection_op([0, 3])),
         P.make_control_op([1], P.make_reflection_op([0, 3]))),
    ]


def check_op_to_dense(ref, port, algebra):
    """One op algebra applied in each package: the same indices, the same
    dense matrix, and interop carries the reference result to the port's."""
    f_ref = {"id": lambda o: o, "conj": R.conj_op,
             "transpose": R.transpose_op, "invert": R.invert_op}[algebra]
    f_port = {"id": lambda o: o, "conj": P.conj_op,
              "transpose": P.transpose_op, "invert": P.invert_op}[algebra]
    r, p = f_ref(ref), f_port(port)
    assert tuple(p.indices) == tuple(r.indices)
    np.testing.assert_array_equal(P.op_to_dense(p), R.op_to_dense(r))
    assert P.op_fingerprint(op_from_reference(r)) == P.op_fingerprint(p)


@pytest.mark.parametrize("name,ref,port", _pairs(), ids=[p[0] for p in _pairs()])
@pytest.mark.parametrize("algebra", ["id", "conj"])
def test_op_to_dense_matches_reference(name, ref, port, algebra):
    """The identity and the conjugate of each op (its transpose and inverse:
    ``test_torch_ops_algebra.py``)."""
    check_op_to_dense(ref, port, algebra)


def test_make_op_matrix_and_gates_match_reference():
    op_r = R.make_control_op([0], R.make_matrix_op([2], rgates.H.reshape(-1)))
    op_p = P.make_control_op([0], P.make_matrix_op([2], pgates.H.reshape(-1)))
    np.testing.assert_array_equal(P.make_op_matrix(3, op_p), R.make_op_matrix(3, op_r))
    for name in ("I2", "X", "Y", "Z", "H", "S", "T", "CNOT", "SWAP"):
        np.testing.assert_array_equal(getattr(pgates, name), getattr(rgates, name))
    from rustqip_tpu.types import PiRational as RPi

    for fn in ("rz", "rx", "ry", "phase", "global_phase"):
        np.testing.assert_array_equal(
            getattr(pgates, fn)(PiRational(1, 3)), getattr(rgates, fn)(RPi(1, 3))
        )
        np.testing.assert_array_equal(getattr(pgates, fn)(0.7), getattr(rgates, fn)(0.7))


def test_constructor_errors_match_reference():
    from rustqip_tpu.errors import CircuitError as RErr

    from rustqip_tpu_torch.errors import CircuitError as PErr

    bad = [
        (lambda M: M.make_matrix_op([], [1])),
        (lambda M: M.make_matrix_op([0], [1, 0, 0])),
        (lambda M: M.make_swap_op([0], [1, 2])),
        (lambda M: M.make_control_op([], M.make_matrix_op([0], np.eye(2)))),
        (lambda M: M.make_reflection_op([1, 1])),
        (lambda M: M.make_sparse_matrix_op([0], [[(0, 1)], []])),
    ]
    for f in bad:
        with pytest.raises(RErr):
            f(R)
        with pytest.raises(PErr):
            f(P)


@pytest.mark.parametrize(
    "indices", [(3, 0, 12, 9), (13,), (5, 1, 7, 2, 11, 8, 0), tuple(range(14))],
    ids=["mixed4", "one_lane", "rows_and_lanes7", "all14"],
)
def test_probs_plan_matches_reference(indices):
    """The measurement plan (lane-reduction matrix, the outcome order,
    which the port builds by doubling, and the measured row and lane
    counts) equals the JAX package's at n = 14. The port reduces rows per
    block, so it has no whole-state row steps to compare."""
    from rustqip_tpu.ops.measurement_ops import _probs_plan as ref_plan

    from rustqip_tpu_torch.ops.measurement_ops import _outcome_perm, _probs_plan

    got, want = _probs_plan(14, indices), ref_plan(14, indices)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(_outcome_perm(got[1], "cpu").numpy(), want[2])
    assert got[2:] == want[3:]
