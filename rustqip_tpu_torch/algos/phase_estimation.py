"""Generic quantum phase estimation (port of
``rustqip_tpu/algos/phase_estimation.py``).

The textbook QPE circuit: ``m`` phase qubits in superposition control
``U^{2^j}`` powers on a target register, then an inverse QFT on the phase
register concentrates the amplitude on ``round(phi * 2^m)`` for an
eigenphase ``e^{2 pi i phi}``.

No direct reference analog as a packaged routine (RustQIP ships the
building blocks — conditioning, QFT — but no QPE); Shor period finding
(``algos/shor.py``) is the specialized instance over modular
multiplication. Controlled ``U^{2^j}`` powers apply as single native
controlled unitaries (ControlledMatGate — one engine pass each), the
capability the reference leaves ``todo!()`` (qip/src/builder.rs:808).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from rustqip_tpu_torch.algos.qfft import qfft_inverse
from rustqip_tpu_torch.errors import CircuitError
from rustqip_tpu_torch.utils.bits import flip_bits


def phase_estimate(b, unitary: np.ndarray, m: int, prepare=None):
    """Record a QPE circuit on builder ``b``.

    ``unitary`` is the 2^k x 2^k matrix whose eigenphase is estimated;
    ``m`` is the number of phase-register qubits (the precision);
    ``prepare(b, target) -> target`` optionally prepares the target
    register in (an approximation of) the desired eigenstate — default
    leaves it |0...0>.

    Returns ``(phase_register, target_register, handle)`` where ``handle``
    reads the measured phase estimate: ``phi ~ outcome / 2^m``.
    """
    u = np.asarray(unitary, dtype=np.complex128)
    dim = u.shape[0]
    if u.ndim != 2 or u.shape[0] != u.shape[1] or (dim & (dim - 1)):
        raise CircuitError("phase_estimate needs a square 2^k x 2^k matrix")
    k = dim.bit_length() - 1
    if m < 1:
        raise CircuitError("phase_estimate needs at least one phase qubit")

    phase = b.register(m)
    target = b.register(k)
    if prepare is not None:
        target = prepare(b, target)
    phase = b.h(phase)

    # qfft_inverse is exactly F^dagger on big-endian STATE indices (tested
    # against the DFT matrix), so encode the phase integer in state-index
    # space: phase qubit j is state bit (m-1-j) and controls U^(2^(m-1-j)).
    pqs = b.split_all_register(phase)
    power = u
    for j in reversed(range(m)):
        cb = b.condition_with(pqs[j])
        target = cb.apply_matrix(target, power)
        pqs[j] = cb.dissolve()
        power = power @ power
    phase = b.merge_registers(pqs)

    phase = qfft_inverse(b, phase)
    phase, handle = b.measure(phase)
    return phase, target, handle


def estimate_phase(
    b, unitary: np.ndarray, m: int, prepare=None,
    seed: Optional[int] = None,
) -> Tuple[float, float]:
    """Build, run, and read a QPE estimate: returns ``(phi, prob)`` with
    ``phi`` in [0, 1). The circuit runs where ``b`` keeps its state (the
    CUDA card unless ``b`` was made with ``device="cpu"``)."""
    _, _, handle = phase_estimate(b, unitary, m, prepare)
    _, measured = b.calculate_state(seed=seed)
    outcome, prob = measured.get_measurement(handle)
    # measured value is little-endian over the register's qubits; the
    # phase integer lives in state-index (big-endian) space.
    return flip_bits(m, int(outcome)) / (1 << m), prob
