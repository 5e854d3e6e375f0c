"""Algorithm library (L4): QFT, reversible arithmetic, Grover search,
quantum phase estimation, Shor period finding / factoring (port of
``rustqip_tpu/algos``).

Re-design of the reference's ``qip/src/qfft.rs`` and
``qip/src/boolean_circuits/arithmetic.rs`` on top of the ``program``/
``invertible`` DSL, plus Grover, QPE, and Shor (the reference ships only
building blocks; here they're library routines).
"""

from rustqip_tpu_torch.algos.qfft import qfft, qfft_inverse
from rustqip_tpu_torch.algos.arithmetic import (
    add,
    add_mod,
    carry,
    copy,
    exp_mod,
    lshift,
    rshift,
    square_mod,
    sum_,
    times_mod,
)
from rustqip_tpu_torch.algos.grover import grover_search, grover_iteration
from rustqip_tpu_torch.algos.phase_estimation import estimate_phase, phase_estimate
from rustqip_tpu_torch.algos.shor import factor, find_period, shor_period_circuit

__all__ = [
    "qfft",
    "qfft_inverse",
    "add",
    "add_mod",
    "carry",
    "copy",
    "exp_mod",
    "lshift",
    "rshift",
    "square_mod",
    "sum_",
    "times_mod",
    "grover_search",
    "grover_iteration",
    "phase_estimate",
    "estimate_phase",
    "shor_period_circuit",
    "find_period",
    "factor",
]
