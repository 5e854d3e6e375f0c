"""The port's Shor against the JAX package (f64, 1e-10) and against its
closed form: the Shor cases of ``tests/test_aux.py``, run on the CPU
(``device="cpu"``)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from rustqip_tpu.algos import shor_period_circuit as j_shor  # noqa: E402
from rustqip_tpu.prelude import LocalBuilder as JBuilder  # noqa: E402

from rustqip_tpu_torch.algos import factor, find_period, shor_period_circuit  # noqa: E402
from rustqip_tpu_torch.algos.shor import period_from_distribution  # noqa: E402
from rustqip_tpu_torch.prelude import LocalBuilder as TBuilder  # noqa: E402
from rustqip_tpu_torch.utils.bits import flip_bits  # noqa: E402

torch.set_num_threads(1)  # the test runner keeps one worker per core busy

TOL = 1e-10


def _port():
    return TBuilder(dtype="f64", device="cpu")


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
