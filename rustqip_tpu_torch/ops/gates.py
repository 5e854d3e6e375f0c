"""Standard gate matrices.

Single source of truth for the numeric content of the named gates the builder
emits (reference: gate lowering at ``qip/src/builder.rs:439-498`` and the
``make_*`` constructors at ``qip/src/builder_traits.rs:290-375``).

Matrices are numpy complex128; the engine casts to the simulation dtype when
lowering. Convention: row = output, col = input; for multi-qubit gates the
first listed qubit is the most significant bit of row/col (big-endian).
"""

from __future__ import annotations

import numpy as np

from rustqip_tpu_torch.types import Angle, angle_to_float

_SQRT1_2 = 1.0 / np.sqrt(2.0)

I2 = np.eye(2, dtype=np.complex128)
X = np.array([[0, 1], [1, 0]], dtype=np.complex128)
Y = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
Z = np.array([[1, 0], [0, -1]], dtype=np.complex128)
H = np.array([[_SQRT1_2, _SQRT1_2], [_SQRT1_2, -_SQRT1_2]], dtype=np.complex128)
S = np.array([[1, 0], [0, 1j]], dtype=np.complex128)
T = np.array([[1, 0], [0, np.exp(1j * np.pi / 4)]], dtype=np.complex128)

#: CNOT with the first qubit as control (``qip/src/builder_traits.rs:371``).
CNOT = np.array(
    [
        [1, 0, 0, 0],
        [0, 1, 0, 0],
        [0, 0, 0, 1],
        [0, 0, 1, 0],
    ],
    dtype=np.complex128,
)

SWAP = np.array(
    [
        [1, 0, 0, 0],
        [0, 0, 1, 0],
        [0, 1, 0, 0],
        [0, 0, 0, 1],
    ],
    dtype=np.complex128,
)


def rz(theta: Angle) -> np.ndarray:
    """Rz = diag(e^{-i theta/2}, e^{+i theta/2})
    (``qip/src/builder.rs:479-496``)."""
    half = 0.5 * angle_to_float(theta)
    return np.array(
        [[np.exp(-1j * half), 0], [0, np.exp(1j * half)]], dtype=np.complex128
    )


def rx(theta: Angle) -> np.ndarray:
    half = 0.5 * angle_to_float(theta)
    c, s = np.cos(half), np.sin(half)
    return np.array([[c, -1j * s], [-1j * s, c]], dtype=np.complex128)


def ry(theta: Angle) -> np.ndarray:
    half = 0.5 * angle_to_float(theta)
    c, s = np.cos(half), np.sin(half)
    return np.array([[c, -s], [s, c]], dtype=np.complex128)


def phase(theta: Angle) -> np.ndarray:
    """diag(1, e^{i theta}) — the |1>-phase gate."""
    return np.array(
        [[1, 0], [0, np.exp(1j * angle_to_float(theta))]], dtype=np.complex128
    )


def global_phase(theta: Angle) -> np.ndarray:
    return np.exp(1j * angle_to_float(theta)) * I2
