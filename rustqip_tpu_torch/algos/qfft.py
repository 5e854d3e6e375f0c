"""Quantum Fourier transform (port of ``rustqip_tpu/algos/qfft.py``).

Re-design of the reference ``qfft`` (qip/src/qfft.rs:7-40): per-qubit
Hadamard + controlled-phase ladder, then reversal swaps — generic over any
builder implementing the trait tower (works conditioned, inverted, etc.).

Exactness notes vs the reference (whose qfft is untested upstream):
* the controlled phase is a true CP(pi/2^(j-i)) — rz plus a global phase of
  half the angle, conditioned together (a bare conditioned rz would leave a
  stray phase on the control);
* conditioning actually applies here (the reference's Conditioned wrapper
  delegates rz* to the parent unconditioned, conditioning.rs:130-168).

Resulting matrix (verified in tests): the DFT with F[j,k] = w^{jk}/sqrt(N)
on big-endian state indices.
"""

from __future__ import annotations

from rustqip_tpu_torch.types import PiRational


def qfft(b, r):
    """Apply the QFT to register ``r``; returns the new register handle."""
    rs = list(b.split_all_register(r))
    k = len(rs)
    for i in range(k):
        ri = rs[i]
        ri = b.h(ri)
        for j in range(i + 1, k):
            cb = b.condition_with(rs[j])
            # Exact controlled-phase CP(pi / 2^(j-i)):
            ri = cb.rz_ratio(ri, PiRational(1, 1 << (j - i)))
            ri = cb.apply_global_phase_ratio(ri, PiRational(1, 2 << (j - i)))
            rs[j] = cb.dissolve()
        rs[i] = ri
    # Bit-reversal swaps (qfft.rs:29-37) — native SWAP objects, which
    # coalesce into ONE permutation gather pass at execution (the
    # reference's 3-CNOT swaps cost a pass per pair).
    for i in range(k // 2):
        a, bq = rs[i], rs[k - 1 - i]
        a, bq = b.swap_registers(a, bq)
        rs[i], rs[k - 1 - i] = a, bq
    return b.merge_registers(rs)


def qfft_inverse(b, r):
    """Apply the inverse QFT (shadow-builder inversion of ``qfft``)."""
    from rustqip_tpu_torch.builder.inverter import inverter

    (r,) = inverter(b, [r], lambda bb, rr: [qfft(bb, rr)])
    return r
