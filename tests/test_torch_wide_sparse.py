"""Sparse ops wider than ``DENSE_CAP`` in the port: gather passes against
the JAX package's on the same seeded state (k = 11 and 12, permutations
with phases, multi-entry rows, little-endian input, a control around a
wide op, the builder surface and its inverse), against closed forms, and
the width cap. Tolerance: 1e-10 in f64 (BASELINE.md row 3), 1e-5 in f32.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rustqip_tpu.engine.real_apply import apply_op_ri as ref_apply  # noqa: E402
from rustqip_tpu.ops import matrix_ops as R  # noqa: E402
from rustqip_tpu.types import Representation as RRep  # noqa: E402

from rustqip_tpu_torch.engine import apply as port_apply  # noqa: E402
from rustqip_tpu_torch.engine.apply import DENSE_CAP  # noqa: E402
from rustqip_tpu_torch.engine.real_apply import apply_op_ri  # noqa: E402
from rustqip_tpu_torch.errors import CircuitError  # noqa: E402
from rustqip_tpu_torch.interop import (  # noqa: E402
    op_from_reference,
    planes_from_numpy,
    planes_to_numpy,
)
from rustqip_tpu_torch.ops import matrix_ops as P  # noqa: E402
from rustqip_tpu_torch.types import Representation  # noqa: E402

torch.set_num_threads(1)  # the test runner keeps one worker per core busy

F64, F32 = 1e-10, 1e-5


def _state(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return v / np.linalg.norm(v)


def _perm_rows(k, seed):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(1 << k)
    ph = np.exp(1j * rng.uniform(-3, 3, 1 << k))
    return [[(int(perm[i]), complex(ph[i]))] for i in range(1 << k)]


def _mix_rows(k):
    """2 entries per row: 2x2 rotations on the last sub bit, phased by the
    other bits."""
    c, s = np.cos(0.3), np.sin(0.3)

    def f(row):
        phase = np.exp(1j * 0.001 * (row >> 1))
        if row & 1 == 0:
            return [(row, c * phase), (row | 1, -s * phase)]
        return [(row & ~1, s * phase), (row, c * phase)]

    return R.make_sparse_matrix_from_function(k, f)


def _cases():
    """(n, reference op) for ops wider than DENSE_CAP."""
    return {
        "perm_k11_rows_and_lanes": (12, R.make_sparse_matrix_op(
            [11, 0, 5, 2, 9, 3, 7, 1, 10, 4, 6], _perm_rows(11, 1))),
        "perm_k12_whole_state": (12, R.make_sparse_matrix_op(
            list(range(12)), _perm_rows(12, 2))),
        "multi_entry_k11": (12, R.make_sparse_matrix_op(list(range(11)), _mix_rows(11))),
        "little_endian_k11": (12, R.make_sparse_matrix_op(
            list(range(1, 12)), _perm_rows(11, 3), RRep.LittleEndian)),
        "controlled_k11": (13, R.make_control_op(
            [0], R.make_sparse_matrix_op(list(range(2, 13)), _perm_rows(11, 4)))),
    }


CASES = _cases()


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_wide_sparse_matches_reference(name, prec):
    n, ref_op = CASES[name]
    op = op_from_reference(ref_op)
    assert op.num_indices > DENSE_CAP
    v = _state(n, 7)
    npd, td = (np.float64, torch.float64) if prec == "f64" else (np.float32, torch.float32)
    er, ei = ref_apply(n, ref_op, jnp.asarray(v.real.astype(npd)),
                       jnp.asarray(v.imag.astype(npd)))
    want = np.asarray(er, np.float64) + 1j * np.asarray(ei, np.float64)
    got = planes_to_numpy(*apply_op_ri(n, op, *planes_from_numpy(v, dtype=td)))
    assert np.abs(got - want).max() <= (F64 if prec == "f64" else F32)


def test_gather_blocks_and_closed_form(monkeypatch):
    """A permutation oracle |x> -> |5x mod 4001> (identity above 4001) on
    the 12 top qubits of 13: the closed form by direct indexing, with the
    gather cut into many row blocks."""
    monkeypatch.setattr(port_apply, "GATHER_BLOCK", 1 << 9)
    n, k, a, N = 13, 12, 5, 4001
    fx = np.array([(a * x) % N if x < N else x for x in range(1 << k)])
    inv = np.empty_like(fx)
    inv[fx] = np.arange(1 << k)
    op = P.make_sparse_matrix_op(list(range(k)), [[(int(inv[r]), 1.0)] for r in range(1 << k)])
    v = _state(n, 8)
    full = np.arange(1 << n)
    want = np.empty_like(v)
    want[(fx[full >> 1] << 1) | (full & 1)] = v
    got = planes_to_numpy(*apply_op_ri(n, op, *planes_from_numpy(v, dtype=torch.float64)))
    assert np.abs(got - want).max() <= 1e-12


def test_builder_sparse_from_function_and_inverse_match_reference():
    """apply_sparse_matrix_from_function (a 12-qubit phase oracle) and a
    12-qubit permutation undone by its inverted subcircuit, on both
    packages."""
    from rustqip_tpu.prelude import LocalBuilder as RB

    from rustqip_tpu_torch.prelude import LocalBuilder as PB

    marked = 0x5A3
    rows = _perm_rows(12, 9)

    def build(b):
        r = b.h(b.register(12))
        r = b.apply_sparse_matrix_from_function(
            r, lambda row: [(row, -1.0 if row == marked else 1.0)])
        start = len(b.pipeline)
        r = b.apply_sparse_matrix(r, rows)
        return b.apply_inverted_subcircuit(b.pipeline[start:], r)

    rb = RB(dtype="c128")
    build(rb)
    want = np.asarray(rb.calculate_state(seed=0)[0])
    pb = PB(dtype="c128", device="cpu")
    build(pb)
    got = np.asarray(pb.calculate_state(seed=0)[0])
    assert np.abs(got - want).max() <= F64
    amp = 2.0 ** -6
    assert np.isclose(got, -amp, atol=1e-12).sum() == 1
    assert np.isclose(got, amp, atol=1e-12).sum() == (1 << 12) - 1


def test_sparse_width_cap_clear_error():
    k = P.MAX_SPARSE_BITS + 1
    with pytest.raises(CircuitError, match="MAX_SPARSE_BITS"):
        P.make_sparse_matrix_from_function(k, lambda r: [(r, 1.0)])
    with pytest.raises(CircuitError, match="supported width"):
        P.make_sparse_matrix_op(list(range(k)), [[(0, 1.0)]])
    rows = P.make_sparse_matrix_from_function(4, lambda r: [(r, 1.0)], Representation.LittleEndian)
    assert rows == [[(r, 1.0)] for r in range(16)]
