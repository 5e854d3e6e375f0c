"""The port's per-op plane engine (``real_apply.apply_op_ri``) against the
JAX package's, per op type (dense, sparse, swap and controlled ops here;
phase products and reflections in ``test_torch_engine_phase.py``), in
float32 and float64 on the same seeded normalized state. Tolerances: 1e-10
in f64 (BASELINE.md row 3), 1e-6 in f32 (``scripts/kernel_parity.py``)."""

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

torch.set_num_threads(1)  # the test runner keeps one worker per core busy

N = 14  # 7 row qubits (0..6), 7 lane qubits (7..13)
TOL = {"f64": 1e-10, "f32": 1e-6}


def _u(k, seed):
    r = np.random.default_rng(seed)
    m = r.normal(size=(1 << k, 1 << k)) + 1j * r.normal(size=(1 << k, 1 << k))
    return np.linalg.qr(m)[0].reshape(-1)


def _cases():
    X = gates.X.reshape(-1)
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
    }


CASES = _cases()


def check_against_reference(op, prec):
    """``op`` (a JAX package op) through both engines on a seeded state."""
    rng = np.random.default_rng(42)
    v = rng.normal(size=1 << N) + 1j * rng.normal(size=1 << N)
    v /= np.linalg.norm(v)
    npd = np.float64 if prec == "f64" else np.float32
    er, ei = ref_apply(
        N, op, jnp.asarray(v.real.astype(npd)), jnp.asarray(v.imag.astype(npd))
    )
    want = np.asarray(er, np.float64) + 1j * np.asarray(ei, np.float64)
    td = torch.float64 if prec == "f64" else torch.float32
    pr, pi = planes_from_numpy(v, dtype=td, device="cpu")
    gr, gi = apply_op_ri(N, op_from_reference(op), pr, pi)
    assert gr.dtype == td and tuple(gr.shape) == (1 << (N - 7), 128)
    got = planes_to_numpy(gr, gi)
    assert np.abs(got - want).max() <= TOL[prec]


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_apply_op_ri_matches_reference(name, prec):
    check_against_reference(CASES[name], prec)
