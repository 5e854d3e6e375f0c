"""The port's QFT inverse, phase estimation and Shor against the JAX
package (f64, 1e-10) and against their closed forms: the cases of
``tests/test_algos.py``, ``tests/test_phase_estimation.py`` and the Shor
cases of ``tests/test_aux.py``, run on the CPU (``device="cpu"``)."""

import numpy as np
import pytest

pytest.importorskip("jax")

from rustqip_tpu.algos import phase_estimate as j_phase_estimate  # noqa: E402
from rustqip_tpu.algos import qfft_inverse as j_qfft_inverse  # noqa: E402
from rustqip_tpu.algos import shor_period_circuit as j_shor  # noqa: E402
from rustqip_tpu.prelude import LocalBuilder as JBuilder  # noqa: E402
from rustqip_tpu.prelude import make_circuit_matrix as j_matrix  # noqa: E402

from rustqip_tpu_torch.algos import (  # noqa: E402
    estimate_phase,
    factor,
    find_period,
    phase_estimate,
    qfft,
    qfft_inverse,
    shor_period_circuit,
)
from rustqip_tpu_torch.algos.shor import period_from_distribution  # noqa: E402
from rustqip_tpu_torch.errors import CircuitError  # noqa: E402
from rustqip_tpu_torch.prelude import LocalBuilder as TBuilder  # noqa: E402
from rustqip_tpu_torch.prelude import make_circuit_matrix as t_matrix  # noqa: E402
from rustqip_tpu_torch.utils.bits import flip_bits  # noqa: E402

TOL = 1e-10


def _port():
    return TBuilder(dtype="f64", device="cpu")


@pytest.mark.parametrize("k", range(1, 7))
def test_qfft_inverse_matches_jax_and_inverse_dft(k):
    b = _port()
    got = t_matrix(b, qfft_inverse(b, b.register(k)))
    jb = JBuilder()
    want = j_matrix(jb, j_qfft_inverse(jb, jb.register(k)))
    assert np.abs(got - want).max() <= TOL
    N = 1 << k
    w = np.exp(-2j * np.pi / N)
    idft = np.array([[w ** (i * j) for j in range(N)] for i in range(N)]) / np.sqrt(N)
    assert np.abs(got - idft).max() <= TOL


@pytest.mark.parametrize("k", [3, 5])
def test_qfft_round_trip_is_identity(k):
    b = _port()
    r = b.register(k)
    full = t_matrix(b, qfft_inverse(b, qfft(b, r)))
    assert np.abs(full - np.eye(1 << k)).max() <= TOL


def _prep_one(b, t):
    return b.x(t)


@pytest.mark.parametrize("k", range(8))
def test_dyadic_phase_exact(k):
    # phi = k/8 is exactly representable in 3 phase bits: certainty.
    phi = k / 8
    u = np.diag([1.0, np.exp(2j * np.pi * phi)])
    got, p = estimate_phase(_port(), u, 3, prepare=_prep_one, seed=0)
    assert abs(got - phi) < 1e-12
    assert p > 1 - 1e-9


def test_nondyadic_phase_within_resolution():
    phi = 0.3
    u = np.diag([1.0, np.exp(2j * np.pi * phi)])
    got, _ = estimate_phase(_port(), u, 5, prepare=_prep_one, seed=3)
    assert abs(got - phi) <= 1 / 32 + 1e-9


def test_two_qubit_unitary_eigenphase():
    # CZ has eigenvalue -1 on |11>: phi = 1/2, measured exactly.
    cz = np.diag([1.0, 1.0, 1.0, -1.0])
    got, p = estimate_phase(_port(), cz, 3, prepare=_prep_one, seed=1)
    assert abs(got - 0.5) < 1e-12
    assert p > 1 - 1e-9


@pytest.mark.parametrize("mat,m", [(np.ones((3, 3)), 2), (np.eye(2), 0)], ids=["not_2k", "no_qubits"])
def test_phase_estimate_validation(mat, m):
    with pytest.raises(CircuitError):
        phase_estimate(_port(), mat, m)


def _qpe_state(B, pe, u, m, outcome, **kw):
    b = B(**kw)
    _, _, handle = pe(b, u, m, prepare=lambda bb, t: bb.x(t))
    state, measured = b.calculate_state_with_init(conditions={handle: outcome})
    return np.asarray(state), measured.get_measurement(handle), b


def test_qpe_final_state_matches_jax():
    """m = 6 phase qubits, k = 2 target qubits, a seeded random 4x4
    unitary (its eigenvector is not prepared, so the phase register holds a
    superposition), the phase measurement forced to the same outcome in
    both packages: amplitude by amplitude against the JAX package."""
    rng = np.random.default_rng(6)
    a = rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))
    u = np.linalg.qr(a)[0]
    got, (g_out, g_p), tb = _qpe_state(TBuilder, phase_estimate, u, 6, 5, dtype="f64",
                                       device="cpu")
    want, (w_out, w_p), _ = _qpe_state(JBuilder, j_phase_estimate, u, 6, 5)
    assert tb.n == 8 and g_out == w_out == 5
    assert 0.0 < g_p and abs(g_p - w_p) <= TOL
    assert np.abs(got - want).max() <= TOL
    assert abs(np.linalg.norm(got) - 1) <= TOL


@pytest.mark.parametrize("a,r", [(7, 4), (2, 4), (4, 2)])
def test_find_period(a, r):
    assert find_period(a, 15, device="cpu") == r


def test_factor_15():
    result = factor(15, seed=1, device="cpu")
    assert result is not None and sorted(result) == [3, 5]


def test_period_circuit_state_matches_jax():
    b = _port()
    ex, work, _ = shor_period_circuit(b, 7, 15)
    assert (ex.n, work.n) == (8, 4)
    got, _ = b.calculate_state(seed=0)
    jb = JBuilder()
    j_shor(jb, 7, 15)
    want, _ = jb.calculate_state(seed=0)
    assert np.abs(got - np.asarray(want)).max() <= TOL


def _period_distribution(a, N, t):
    """Outcome distribution of the period circuit as built, in closed form.
    Exponent qubit j controls a^(2^j), so the exponent value x is the
    bit-reversal of the big-endian index X that the inverse QFT reads (the
    JAX package's convention, carried over): for each residue s of x mod r,
    the transform of the indicator of {X : rev(X) = s mod r}."""
    r = next(k for k in range(1, N) if pow(a, k, N) == 1)
    T = 1 << t
    X = np.arange(T)
    rev = np.zeros(T, dtype=np.int64)
    for j in range(t):
        rev |= ((X >> j) & 1) << (t - 1 - j)
    res = rev % r
    half = np.zeros(T // 2 + 1)  # a real input's transform is symmetric
    for s in range(r):
        half += np.abs(np.fft.rfft((res == s).astype(np.float64)) / T) ** 2
    probs = np.concatenate([half, half[1:-1][::-1]])
    return r, probs, rev


@pytest.mark.parametrize("a,N,t", [(7, 15, 8), (2, 437, 19)], ids=["7_mod_15", "2_mod_437_t19"])
def test_period_post_processing_on_the_closed_form_distribution(a, N, t):
    """``find_period``'s classical post-processing on the closed-form
    distribution (outcome bit i = exponent qubit i, so outcome m is index
    flip_bits(t, m)): order 198 for 2 mod 437 at t = 19, the n = 28 case run
    on the card; for 7 mod 15 the port's own distribution matches it."""
    r, probs, rev = _period_distribution(a, N, t)
    assert abs(probs.sum() - 1) < 1e-9
    assert all(rev[m] == flip_bits(t, m) for m in (1, 2, 5, (1 << t) - 2))
    by_outcome = probs[rev]
    assert period_from_distribution(by_outcome, a, N, t) == r
    if N == 15:
        b = _port()
        _, _, handle = shor_period_circuit(b, a, N, t=t)
        _, measured = b.calculate_state(seed=0)
        assert np.abs(measured.get_stochastic_measurement(handle) - by_outcome).max() <= TOL
