"""The port's measurement of flat complex states (``prob_magnitude``,
``measure_probs``, ``measure_state``, ``measure``, ``measure_ri``) against
the JAX package's, case for case with ``tests/test_measurement.py``'s
complex cases, and the reflection through ``engine.apply_op`` as in
``tests/test_reflection.py::test_reflection_engine_paths_match_dense``.
Draws use a ``torch.Generator`` (torch cannot reproduce ``jax.random``), so
sampled outcomes are held to their distribution (5 sigma), and forced
outcomes to the JAX package's numbers. Tolerances: 1e-10 in complex128,
1e-6 in complex64.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rustqip_tpu.engine import apply as RA  # noqa: E402
from rustqip_tpu.ops import matrix_ops as R  # noqa: E402
from rustqip_tpu.ops import measurement_ops as RM  # noqa: E402

from rustqip_tpu_torch.engine import apply_op  # noqa: E402
from rustqip_tpu_torch.errors import CircuitError  # noqa: E402
from rustqip_tpu_torch.interop import op_from_reference, planes_from_numpy  # noqa: E402
from rustqip_tpu_torch.ops import (  # noqa: E402
    MeasuredCondition,
    measure,
    measure_probs,
    measure_state,
    prob_magnitude,
)
from rustqip_tpu_torch.ops import measurement_ops as M  # noqa: E402

torch.set_num_threads(1)  # the test runner keeps one worker per core busy

TOL = {np.complex128: 1e-10, np.complex64: 1e-6}
BASIS_10 = np.array([0.0, 0.0, 1.0, 0.0])  # |10>: q0 = 1, q1 = 0
PLUS_PLUS = np.full(4, 0.5)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _state(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return v / np.linalg.norm(v)


@pytest.mark.parametrize("dt", [np.complex128, np.complex64], ids=["c128", "c64"])
def test_measure_prob_big_endian_convention(dt):
    # ref doctest measurement_ops.rs:25-43
    state = torch.as_tensor(BASIS_10.astype(dt))
    for m, idx, want in ((0, [0], 0.0), (1, [0], 1.0), (1, [0, 1], 1.0), (2, [1, 0], 1.0)):
        got = float(measure_probs(2, idx, state)[m])
        assert got == want == float(RM.measure_prob(2, m, idx, jnp.asarray(BASIS_10.astype(dt))))


def test_soft_measure_convention():
    # ref doctest measurement_ops.rs:137-151: a basis state draws its own bits
    state = torch.as_tensor(BASIS_10.astype(np.complex128))
    key = jax.random.PRNGKey(0)
    for idx, want in (([0], 1), ([1], 0), ([0, 1], 0b01), ([1, 0], 0b10)):
        assert int(RM.soft_measure(2, idx, jnp.asarray(BASIS_10 + 0j), key)) == want
        outcome, prob, _ = measure(2, idx, state, generator=_gen(idx[0]))
        assert (outcome, prob) == (want, 1.0)


@pytest.mark.parametrize("outcome", [0, 1])
@pytest.mark.parametrize("dt", [np.complex128, np.complex64], ids=["c128", "c64"])
def test_measure_state_collapse(outcome, dt):
    # ref measurement_ops.rs:290-326: measure q0 on |++>
    state = torch.as_tensor(PLUS_PLUS.astype(dt))
    p = float(measure_probs(2, [0], state)[outcome])
    assert abs(p - 0.5) < 1e-12
    got = measure_state(2, [0], (outcome, p), state)
    ref = RM.measure_state(2, [0], (jnp.asarray(outcome), p), jnp.asarray(PLUS_PLUS.astype(dt)))
    h = np.sqrt(0.5)
    want = [h, h, 0, 0] if outcome == 0 else [0, 0, h, h]
    assert got.dtype == state.dtype and got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL[dt])
    np.testing.assert_allclose(got.numpy(), want, atol=TOL[dt])


def test_measure_probs_distribution():
    # ref measurement_ops.rs:329-336
    state = torch.as_tensor(PLUS_PLUS + 0j)
    np.testing.assert_allclose(measure_probs(2, [1], state).numpy(), [0.5, 0.5], atol=1e-12)


def test_measure_probs_multiqubit_order():
    # outcome bit i = qubit indices[i]
    amps = np.array([0.1, 0.2, 0.3, 0.4])
    amps = amps / np.linalg.norm(amps)
    state = torch.as_tensor(amps + 0j)
    sq = amps ** 2
    for idx, want in (([1, 0], sq), ([0, 1], sq[[0, 2, 1, 3]])):
        got = measure_probs(2, idx, state).numpy()
        np.testing.assert_allclose(got, want, atol=1e-12)
        np.testing.assert_allclose(got, np.asarray(RM.measure_probs(2, idx, jnp.asarray(amps + 0j))),
                                   atol=1e-12)


@pytest.mark.parametrize("dt", [np.complex128, np.complex64], ids=["c128", "c64"])
def test_measure_forced_condition(dt):
    state = torch.as_tensor(PLUS_PLUS.astype(dt))
    outcome, prob, collapsed = measure(2, [0], state, measured=MeasuredCondition(measured=1))
    r_out, r_prob, r_col = RM.measure(2, [0], jnp.asarray(PLUS_PLUS.astype(dt)),
                                      measured=RM.MeasuredCondition(measured=1))
    assert outcome == int(r_out) == 1
    assert abs(prob - float(r_prob)) < 1e-12 and abs(prob - 0.5) < 1e-12
    h = np.sqrt(0.5)
    np.testing.assert_allclose(collapsed.numpy(), np.asarray(r_col), atol=TOL[dt])
    np.testing.assert_allclose(collapsed.numpy(), [0, 0, h, h], atol=TOL[dt])
    # a forced prob is used as given, as in the JAX package
    _, prob, collapsed = measure(2, [0], state, measured=MeasuredCondition(1, 0.25))
    _, _, r_col = RM.measure(2, [0], jnp.asarray(PLUS_PLUS.astype(dt)),
                             measured=RM.MeasuredCondition(1, 0.25))
    assert prob == 0.25
    np.testing.assert_allclose(collapsed.numpy(), np.asarray(r_col), atol=TOL[dt])


def test_measure_sampling_statistics():
    """400 seeded draws of |00> / |11> with P(11) = 0.75: the support, the
    share of 11 within 5 sigma, and a renormalized collapse."""
    state = torch.as_tensor(np.array([np.sqrt(0.25), 0, 0, np.sqrt(0.75)]) + 0j)
    g = _gen(7)
    draws = 400
    outcomes = np.array([measure(2, [0, 1], state, generator=g)[0] for _ in range(draws)])
    assert set(np.unique(outcomes)) <= {0, 3}
    sigma = np.sqrt(0.75 * 0.25 / draws)
    assert abs((outcomes == 3).mean() - 0.75) < 5 * sigma
    _, p, collapsed = measure(2, [0, 1], state, generator=g)
    assert p in (0.25, pytest.approx(0.75))
    assert abs(float(prob_magnitude(collapsed)) - 1.0) < 1e-10


@pytest.mark.parametrize("dt", [np.complex128, np.complex64], ids=["c128", "c64"])
def test_prob_magnitude(dt):
    for v in (PLUS_PLUS, _state(9, 1)):
        x = v.astype(dt)
        got = float(prob_magnitude(torch.as_tensor(x)))
        assert abs(got - float(RM.prob_magnitude(jnp.asarray(x)))) < TOL[dt]
        assert abs(got - 1.0) < TOL[dt]


def test_measure_wide_matches_reference_and_planes():
    """n = 10 over row and lane qubits: the distribution and a forced
    collapse equal the JAX package's in both precisions, ``measure`` and
    ``measure_ri`` agree on the same state (forced and seeded), and a
    zero-probability outcome leaves the state as it is."""
    n = 10
    v = _state(n, 3)
    idx = [9, 0, 4, 7]
    for dt in (np.complex128, np.complex64):
        x = v.astype(dt)
        t = torch.as_tensor(x)
        probs = measure_probs(n, idx, t)
        np.testing.assert_allclose(probs.numpy(), np.asarray(RM.measure_probs(n, idx, jnp.asarray(x))),
                                   atol=TOL[dt])
        out, prob, col = measure(n, idx, t, measured=MeasuredCondition(5))
        _, r_prob, r_col = RM.measure(n, idx, jnp.asarray(x), measured=RM.MeasuredCondition(5))
        assert abs(prob - float(r_prob)) < TOL[dt]
        np.testing.assert_allclose(col.numpy(), np.asarray(r_col), atol=TOL[dt])
        rdt = torch.float64 if dt is np.complex128 else torch.float32
        re, im = planes_from_numpy(x, dtype=rdt, device="cpu")
        o2, p2, cr, ci = M.measure_ri(n, idx, re, im, measured=MeasuredCondition(5))
        assert (o2, p2) == (out, prob)
        assert torch.equal(torch.complex(cr, ci).reshape(-1), col)
        assert measure(n, idx, t, generator=_gen(3))[:2] == M.measure_ri(n, idx, re, im,
                                                                         generator=_gen(3))[:2]
    zero = torch.as_tensor(BASIS_10 + 0j)
    keep = zero.clone()
    same = measure_state(2, [0], (0, 0.0), zero)
    assert torch.equal(same, zero) and same.data_ptr() != zero.data_ptr()
    same[0] = 7.0  # a new tensor: writing it leaves the input alone
    assert torch.equal(zero, keep)


def test_measure_block_draw_matches_planes():
    """17 measured qubits (past the one-stage draw's 2^16 outcomes): the
    two-stage draw of ``measure`` equals ``measure_ri``'s for each seed,
    and the drawn outcome has a nonzero probability."""
    n = 17
    v = _state(n, 4)
    t = torch.as_tensor(v)
    re, im = planes_from_numpy(v, dtype=torch.float64, device="cpu")
    for seed in (1, 2, 3):
        out, prob, col = measure(n, list(range(n)), t, generator=_gen(seed))
        o2, p2, _, _ = M.measure_ri(n, list(range(n)), re, im, generator=_gen(seed))
        assert (out, prob) == (o2, p2) and prob > 0
        assert abs(float(prob_magnitude(col)) - 1.0) < 1e-10


def test_numpy_state_is_measured_on_device():
    """A numpy state goes to ``device``, the card by default: without
    ``device=`` it raises on a host without CUDA; with ``device="cpu"`` it
    gives what the CPU tensor gives, and the array is left as it was."""
    v = _state(4, 5)
    keep = v.copy()
    t = torch.as_tensor(v)
    calls = (
        lambda **kw: prob_magnitude(v, **kw),
        lambda **kw: measure_probs(4, [1, 3], v, **kw),
        lambda **kw: measure_state(4, [1, 3], (2, 0.25), v, **kw),
        lambda **kw: measure(4, [1, 3], v, measured=MeasuredCondition(2), **kw)[2],
    )
    wants = (
        prob_magnitude(t),
        measure_probs(4, [1, 3], t),
        measure_state(4, [1, 3], (2, 0.25), t),
        measure(4, [1, 3], t, measured=MeasuredCondition(2))[2],
    )
    for call, want in zip(calls, wants):
        got = call(device="cpu")
        assert got.device.type == "cpu" and torch.equal(got, want)
        if not torch.cuda.is_available():
            with pytest.raises((AssertionError, RuntimeError)):
                call()
    assert np.array_equal(v, keep)


def test_measure_without_generator_or_outcome_raises():
    state = torch.as_tensor(PLUS_PLUS + 0j)
    with pytest.raises(CircuitError):
        measure(2, [0], state)
    re, im = planes_from_numpy(PLUS_PLUS + 0j, dtype=torch.float64, device="cpu")
    with pytest.raises(CircuitError):
        M.measure_ri(2, [0], re, im)
    with pytest.raises(CircuitError):
        measure_probs(2, [0, 0], state)


@pytest.mark.parametrize(
    "n,idx",
    [
        (3, [0, 1, 2]),          # all-lane widths
        (4, [1, 3]),
        (9, [0, 2, 3, 7, 8]),    # non-contiguous row + lane mix
        (10, list(range(10))),   # full register across the (R, C) seam
        (10, [0, 9]),            # top row bit + bottom lane bit
        (8, [4]),                # single mid qubit
    ],
)
def test_reflection_engine_paths_match_dense(n, idx):
    """The port's ``apply_op`` of a ``ReflectionOp`` equals the JAX
    package's ``apply_op`` of its dense matrix, and is its own inverse."""
    rng = np.random.default_rng(7)
    psi = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
    psi /= np.linalg.norm(psi)
    ref = R.make_reflection_op(idx)
    want = np.asarray(RA.apply_op(n, R.make_matrix_op(idx, R.op_to_dense(ref).reshape(-1)),
                                  jnp.asarray(psi)))
    op = op_from_reference(ref)
    got = apply_op(n, op, psi, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-10)
    np.testing.assert_allclose(apply_op(n, op, got).numpy(), psi, atol=1e-10)
