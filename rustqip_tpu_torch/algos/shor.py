"""Shor period finding and factoring (port of ``rustqip_tpu/algos/shor.py``).

The quantum core is phase estimation over the modular-multiplication
unitary U_c|y> = |c*y mod N>: the exponent register in superposition
controls U_{a^{2^j}} permutations on the work register, followed by an
inverse QFT and measurement. Each controlled multiplication is a single
native controlled permutation (one engine pass via ControlledMatGate) —
the ancilla-free compiled form of the ``exp_mod`` reversible-arithmetic
construction (algos/arithmetic.py), which is the gate-level route the
reference's building blocks target.

Classical post-processing (continued fractions, order verification,
factor extraction) rounds it out to a full factoring routine.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Optional, Tuple

import numpy as np

from rustqip_tpu_torch.algos.qfft import qfft_inverse
from rustqip_tpu_torch.errors import CircuitError
from rustqip_tpu_torch.utils.bits import flip_bits


def _mod_mult_permutation(c: int, N: int, n: int) -> np.ndarray:
    """Dense permutation matrix for |y> -> |c*y mod N> (identity for y>=N).

    Matrix indices are big-endian over the register's qubits; register
    values are little-endian (bit j on qubit j), hence the flips.
    """
    dim = 1 << n
    mat = np.zeros((dim, dim), dtype=np.complex128)
    for v in range(dim):
        out = (c * v) % N if v < N else v
        mat[flip_bits(n, out), flip_bits(n, v)] = 1.0
    return mat


def shor_period_circuit(b, a: int, N: int, t: Optional[int] = None):
    """Build the period-finding circuit for ``a`` mod ``N``.

    Returns ``(exponent_register, work_register, stochastic_handle)``; the
    outcome distribution over the exponent register peaks at multiples of
    2^t / r.
    """
    if math.gcd(a, N) != 1:
        raise CircuitError(f"a={a} shares a factor with N={N}")
    n = N.bit_length()
    if t is None:
        t = 2 * n
    ex = b.register(t)
    work = b.register(n)

    # work := |1> (value bit 0 -> work qubit 0)
    res = b.split_register_relative(work, [0])
    w0 = b.x(res.selected)
    work = (
        b.merge_two_registers(w0, res.remaining)
        if res.remaining is not None
        else w0
    )

    ex = b.h(ex)  # broadcast H over the exponent register
    exq = b.split_all_register(ex)
    for j in range(t):
        c = pow(a, 1 << j, N)
        if c == 1:
            continue
        cb = b.condition_with(exq[j])
        work = cb.apply_vec_matrix(work, _mod_mult_permutation(c, N, n))
        exq[j] = cb.dissolve()
    ex = b.merge_registers(exq)
    ex = qfft_inverse(b, ex)
    ex, handle = b.measure_stochastic(ex)
    return ex, work, handle


def _candidate_period(y: int, t: int, N: int, a: int) -> Optional[int]:
    """Continued-fraction expansion of y/2^t -> order candidate."""
    if y == 0:
        return None
    frac = Fraction(y, 1 << t).limit_denominator(N)
    r = frac.denominator
    for mult in (1, 2, 3, 4):
        rr = r * mult
        if rr < (1 << t) and pow(a, rr, N) == 1:
            return rr
    return None


def find_period(
    a: int,
    N: int,
    builder_factory=None,
    t: Optional[int] = None,
    seed: int = 0,
    device="cuda",
) -> Optional[int]:
    """Find the multiplicative order of ``a`` mod ``N`` by simulating the
    period-finding circuit and post-processing the outcome distribution.
    The default builder keeps its state on ``device`` (the CUDA card unless
    the caller asks for the CPU)."""
    from rustqip_tpu_torch.builder.builder import LocalBuilder

    b = builder_factory() if builder_factory else LocalBuilder(device=device)
    ex, work, handle = shor_period_circuit(b, a, N, t=t)
    _, measured = b.calculate_state(seed=seed)
    probs = measured.get_stochastic_measurement(handle)
    return period_from_distribution(probs, a, N, ex.n)


def period_from_distribution(probs, a: int, N: int, t: int) -> Optional[int]:
    """``find_period``'s classical post-processing of the exponent
    register's outcome distribution (``t`` qubits)."""
    # Walk outcomes from most probable; outcome bit i = ex qubit i, so the
    # integer readout of the phase is the bit-reversed outcome.
    order = np.argsort(probs)[::-1]
    for m in order[:16]:
        if probs[m] < 1e-6:
            break
        for y in (flip_bits(t, int(m)), int(m)):
            r = _candidate_period(y, t, N, a)
            if r is not None:
                return r
    return None


def factor(
    N: int, attempts: int = 8, seed: int = 0, t: Optional[int] = None,
    device="cuda",
) -> Optional[Tuple[int, int]]:
    """Factor N via Shor's algorithm (quantum period finding simulated on
    device + classical reduction). Returns a nontrivial factor pair."""
    if N % 2 == 0:
        return 2, N // 2
    rng = np.random.default_rng(seed)
    for _ in range(attempts):
        a = int(rng.integers(2, N - 1))
        g = math.gcd(a, N)
        if g > 1:
            return g, N // g
        r = find_period(a, N, seed=seed, t=t, device=device)
        if r is None or r % 2 != 0:
            continue
        x = pow(a, r // 2, N)
        if x == N - 1:
            continue
        p = math.gcd(x - 1, N)
        q = math.gcd(x + 1, N)
        if 1 < p < N:
            return p, N // p
        if 1 < q < N:
            return q, N // q
    return None
