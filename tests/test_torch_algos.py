"""The port's QFT inverse and phase estimation against the JAX package
(f64, 1e-10) and against their closed forms: the cases of
``tests/test_algos.py`` and ``tests/test_phase_estimation.py``, run on the
CPU (``device="cpu"``). Shor is in ``test_torch_shor.py``."""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from rustqip_tpu.algos import phase_estimate as j_phase_estimate  # noqa: E402
from rustqip_tpu.algos import qfft_inverse as j_qfft_inverse  # noqa: E402
from rustqip_tpu.prelude import LocalBuilder as JBuilder  # noqa: E402
from rustqip_tpu.prelude import make_circuit_matrix as j_matrix  # noqa: E402

from rustqip_tpu_torch.algos import (  # noqa: E402
    estimate_phase,
    phase_estimate,
    qfft,
    qfft_inverse,
)
from rustqip_tpu_torch.errors import CircuitError  # noqa: E402
from rustqip_tpu_torch.prelude import LocalBuilder as TBuilder  # noqa: E402
from rustqip_tpu_torch.prelude import make_circuit_matrix as t_matrix  # noqa: E402

torch.set_num_threads(1)  # the test runner keeps one worker per core busy

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
