"""The port's per-op plane engine against the JAX package's on phase
products and reflections (the other op types are in
``test_torch_engine.py``, whose harness this file shares), in float32 and
float64, and the staged reshapes of a reflection under a lowered rank cap.
Tolerances: 1e-10 in f64, 1e-6 in f32."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from test_torch_engine import N, TOL, check_against_reference  # noqa: E402

from rustqip_tpu.engine.real_apply import apply_op_ri as ref_apply  # noqa: E402
from rustqip_tpu.ops import matrix_ops as R  # noqa: E402

from rustqip_tpu_torch.engine.real_apply import apply_op_ri  # noqa: E402
from rustqip_tpu_torch.interop import (  # noqa: E402
    op_from_reference,
    planes_from_numpy,
    planes_to_numpy,
)

torch.set_num_threads(1)  # the test runner keeps one worker per core busy


def _phase(idx, seed, unit=True):
    r = np.random.default_rng(seed)
    d = np.exp(1j * r.uniform(0, 2 * np.pi, size=1 << len(idx)))
    if not unit:
        d = d * r.uniform(0.5, 1.5, size=d.size)
    return (tuple(idx), tuple(complex(v) for v in d))


def _cases():
    many = tuple(_phase((a, b), 100 + a * 16 + b) for a in range(5) for b in range(8, 14))
    return {
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
    check_against_reference(CASES[name], prec)


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
