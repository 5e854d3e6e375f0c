"""Grover search (port of ``rustqip_tpu/algos/grover.py``).

Library routine for unstructured search over n qubits: phase oracle on a
marked basis value + inversion-about-the-mean diffusion. The reference
exposes the ingredients (multi-controlled ops, conditioning); this composes
them — and serves as one of the benchmark flagship circuits
(BASELINE.json config 2).
"""

from __future__ import annotations

import numpy as np

from rustqip_tpu_torch.dsl.program import negate_bitmask


def _multi_controlled_z(b, r):
    """Z on the last qubit controlled on all others (phase flip of |1...1>).

    Uses the engine's native controlled op (one slab update touching only
    the all-controls-|1> sub-tensor) rather than toffoli recursion — the
    reference must decompose into ~15 gates per control (builder_traits.rs:
    541-568); here it is a single pipeline entry at any control count.
    """
    res = b.split_register_relative(r, [r.n - 1])
    target, rest = res.selected, res.remaining
    if rest is None:
        return b.z(target)
    cb = b.condition_with(rest)
    target = cb.apply_vec_matrix(target, np.array([1, 0, 0, -1]))
    rest = cb.dissolve()
    return b.merge_two_registers(rest, target)


def oracle_phase_flip(b, r, marked: int):
    """Flip the phase of the basis state where register value == marked.

    Value convention: bit j of ``marked`` is the register's j-th qubit.
    """
    r = negate_bitmask(b, r, marked)
    r = _multi_controlled_z(b, r)
    return negate_bitmask(b, r, marked)


def diffusion(b, r, native: bool = False):
    """Inversion about the mean: H^n X^n (multi-controlled Z) X^n H^n.

    ``native=True`` applies the engine's ``ReflectionOp`` instead
    (``b.apply_reflection``): ``2|s><s| - I`` as ONE reduction + one
    elementwise pass at any width — equal to the gate composition up to
    a global phase of -1 (the gate form is ``-(2|s><s| - I)``), so all
    measurement statistics coincide while the per-iteration cost drops
    from ~2n+1 state passes to ~2."""
    if native:
        return b.apply_reflection(r)
    r = b.h(r)  # broadcasts
    r = negate_bitmask(b, r, 0)
    r = _multi_controlled_z(b, r)
    r = negate_bitmask(b, r, 0)
    return b.h(r)


def grover_iteration(b, r, marked: int, native_diffusion: bool = False):
    """One oracle + diffusion round."""
    r = oracle_phase_flip(b, r, marked)
    return diffusion(b, r, native=native_diffusion)


def grover_search(
    b, n: int, marked: int, iterations: int = None,
    native_diffusion: bool = False,
):
    """Build a full Grover search circuit on a fresh n-qubit register.

    Returns ``(register, measurement_handle)``; run with
    ``b.calculate_state()`` and read the handle. With the optimal iteration
    count the marked value dominates the outcome distribution.
    ``native_diffusion=True`` swaps the gate-built diffusion for the
    engine's native reflection op (see ``diffusion``) — identical outcome
    distribution, ~(n+1)x fewer state passes per round.
    """
    if iterations is None:
        iterations = max(1, int(np.floor(np.pi / 4 * np.sqrt(2**n))))
    r = b.register(n)
    r = b.h(r)
    # One iteration body, planned once and repeated (not unrolled).
    r = b.repeat(
        iterations,
        lambda bb, rr: grover_iteration(
            bb, rr, marked, native_diffusion=native_diffusion
        ),
        r,
    )
    r, handle = b.measure_stochastic(r)
    return r, handle
