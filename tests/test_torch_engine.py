"""The port's per-op plane engine (``real_apply.apply_op_ri``) against the
JAX package's, per op type, in float32 and float64 on the same seeded
normalized state. Tolerances: 1e-10 in f64 (BASELINE.md row 3), 1e-6 in
f32 (``scripts/kernel_parity.py``)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rustqip_tpu.engine.real_apply import apply_op_ri as ref_apply  # noqa: E402
from rustqip_tpu.ops import gates  # noqa: E402
from rustqip_tpu.ops import matrix_ops as R  # noqa: E402

from rustqip_tpu_torch.engine.real_apply import apply_op_ri  # noqa: E402
from rustqip_tpu_torch.interop import (  # noqa: E402
    op_from_reference,
    planes_from_numpy,
    planes_to_numpy,
)

N = 14  # 7 row qubits (0..6), 7 lane qubits (7..13)
TOL = {"f64": 1e-10, "f32": 1e-6}


def _u(k, seed):
    r = np.random.default_rng(seed)
    m = r.normal(size=(1 << k, 1 << k)) + 1j * r.normal(size=(1 << k, 1 << k))
    return np.linalg.qr(m)[0].reshape(-1)


def _phase(idx, seed, unit=True):
    r = np.random.default_rng(seed)
    d = np.exp(1j * r.uniform(0, 2 * np.pi, size=1 << len(idx)))
    if not unit:
        d = d * r.uniform(0.5, 1.5, size=d.size)
    return (tuple(idx), tuple(complex(v) for v in d))


def _cases():
    X = gates.X.reshape(-1)
    many = tuple(_phase((a, b), 100 + a * 16 + b) for a in range(5) for b in range(8, 14))
    return {
        "dense_row": R.make_matrix_op([2], _u(1, 1)),
        "dense_lane": R.make_matrix_op([10], _u(1, 2)),
        "dense_seam_3q": R.make_matrix_op([5, 1, 12], _u(3, 3)),
        "dense_rows_3q": R.make_matrix_op([0, 3, 6], _u(3, 4)),
        "sparse": R.make_sparse_matrix_op(
            [1, 9, 4], [[((i * 3) % 8, complex(np.exp(0.1j * i)))] for i in range(8)]
        ),
        "swap_rows": R.make_swap_op([0, 1], [3, 5]),
        "swap_lanes": R.make_swap_op([8], [12]),
        "swap_cross": R.make_swap_op([0, 1], [13, 12]),
        "swap_mixed_pair": R.make_swap_op([4], [9]),
        "control_small": R.make_control_op([1, 11], R.make_matrix_op([3], _u(1, 5))),
        "control_wide": R.make_control_op(
            [0, 1, 2, 3, 4, 5, 7, 8, 9, 10, 11], R.make_matrix_op([13], X)
        ),
        "phase_separable": R.PhaseProductOp((_phase((1,), 6), _phase((9,), 7))),
        "phase_mixed": R.PhaseProductOp((_phase((2, 11), 8), _phase((0, 3, 12), 9))),
        "phase_bilinear": R.PhaseProductOp(many),
        "phase_magnitude": R.PhaseProductOp((_phase((1, 10), 10, unit=False),)),
        "reflection_rows": R.make_reflection_op([0, 2, 3]),
        "reflection_mixed": R.make_reflection_op([1, 4, 8, 13]),
        "reflection_controlled": R.make_control_op([6], R.make_reflection_op([0, 9])),
        "reflection_controlled_wide": R.make_control_op(
            [0, 1, 2], R.make_reflection_op([3, 4, 5, 7, 8, 9, 10, 11, 12])
        ),
    }


CASES = _cases()


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_apply_op_ri_matches_reference(name, prec):
    op = CASES[name]
    rng = np.random.default_rng(42)
    v = rng.normal(size=1 << N) + 1j * rng.normal(size=1 << N)
    v /= np.linalg.norm(v)
    npd = np.float64 if prec == "f64" else np.float32
    er, ei = ref_apply(
        N, op, jnp.asarray(v.real.astype(npd)), jnp.asarray(v.imag.astype(npd))
    )
    want = np.asarray(er, np.float64) + 1j * np.asarray(ei, np.float64)
    td = torch.float64 if prec == "f64" else torch.float32
    pr, pi = planes_from_numpy(v, dtype=td)
    gr, gi = apply_op_ri(N, op_from_reference(op), pr, pi)
    assert gr.dtype == td and tuple(gr.shape) == (1 << (N - 7), 128)
    got = planes_to_numpy(gr, gi)
    assert np.abs(got - want).max() <= TOL[prec]


@pytest.mark.parametrize("cap", [5, 7, 25])
@pytest.mark.parametrize("indices", [(0, 2, 4, 6), (0, 2, 4, 6, 9)], ids=["rows", "rows_lane"])
def test_reflection_rank_chunks_match_one_reshape_and_reference(monkeypatch, cap, indices):
    """Alternating row qubits give one reshape axis per row-bit run; under a
    lowered rank cap the runs are summed in stages, each reshape within the
    cap, and the result equals the one-reshape path and the JAX package's."""
    from rustqip_tpu_torch.engine import apply as port_apply

    op = R.make_reflection_op(list(indices))
    rng = np.random.default_rng(11)
    v = rng.normal(size=1 << N) + 1j * rng.normal(size=1 << N)
    v /= np.linalg.norm(v)
    er, ei = ref_apply(N, op, jnp.asarray(v.real), jnp.asarray(v.imag))
    want = np.asarray(er) + 1j * np.asarray(ei)
    one = planes_to_numpy(*apply_op_ri(N, op_from_reference(op), *planes_from_numpy(
        v, dtype=torch.float64)))
    monkeypatch.setattr(port_apply, "MAX_RESHAPE_RANK", cap)
    _, stages = port_apply._reflection_plan(N, tuple(indices))
    assert (len(stages) > 1) == (cap < 8)  # 7 row-bit runs + the lane axis
    assert all(len(shape) <= cap for shape, _ in stages)
    got = planes_to_numpy(*apply_op_ri(N, op_from_reference(op), *planes_from_numpy(
        v, dtype=torch.float64)))
    assert np.abs(got - one).max() <= 1e-12
    assert np.abs(got - want).max() <= TOL["f64"]
