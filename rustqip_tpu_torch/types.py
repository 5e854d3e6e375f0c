"""Precision / dtype handling and bit-order representation.

Port of ``rustqip_tpu/types.py`` without JAX. The reference parameterizes
everything over a ``Precision`` trait covering f32/f64
(``qip/src/types.rs:6-13``); here the analog is a dtype choice:

* ``complex64``  — f32 (re, im) planes; the window kernel's domain.
* ``complex128`` — f64 planes; always the plain torch paths (the JAX
  package never sends f64 to its kernel either).

The default precision is ``complex64``: the port has no global x64 switch
to follow, so builders that need f64 ask for it (``dtype="f64"``).
"""

from __future__ import annotations

import enum
from fractions import Fraction
from typing import Union

import numpy as np
import torch

#: Low-qubit column block = 2^7 = 128 lanes: the canonical (R, 128) plane
#: view shared by the engine, the window kernel and the measurements.
MINOR_QUBITS = 7


class Representation(enum.Enum):
    """Bit order for sparse-matrix input data (``qip/src/types.rs:17-22``)."""

    LittleEndian = "little"
    BigEndian = "big"


DTypeLike = Union[str, type, np.dtype, torch.dtype]

#: numpy real dtype -> torch dtype of the (re, im) planes.
TORCH_REAL = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def default_complex_dtype() -> np.dtype:
    return np.dtype(np.complex64)


def canonical_complex_dtype(dtype: DTypeLike | None) -> np.dtype:
    """Normalize a precision selector ('f32'/'f64'/complex dtypes/float
    dtypes, numpy or torch) to a numpy complex dtype."""
    if dtype is None:
        return default_complex_dtype()
    if isinstance(dtype, torch.dtype):
        dtype = {
            torch.float32: np.float32,
            torch.float64: np.float64,
            torch.complex64: np.complex64,
            torch.complex128: np.complex128,
        }.get(dtype)
        if dtype is None:
            raise ValueError("Unsupported torch precision dtype")
    if isinstance(dtype, str):
        key = dtype.lower()
        if key in ("f32", "float32", "complex64", "c64", "single"):
            return np.dtype(np.complex64)
        if key in ("f64", "float64", "complex128", "c128", "double"):
            return np.dtype(np.complex128)
        raise ValueError(f"Unknown precision {dtype!r}")
    d = np.dtype(dtype)
    if d == np.dtype(np.float32):
        return np.dtype(np.complex64)
    if d == np.dtype(np.float64):
        return np.dtype(np.complex128)
    if d in (np.dtype(np.complex64), np.dtype(np.complex128)):
        return d
    raise ValueError(f"Unsupported precision dtype {dtype!r}")


def real_dtype_of(cdtype: DTypeLike) -> np.dtype:
    d = np.dtype(cdtype)
    if d == np.dtype(np.complex64):
        return np.dtype(np.float32)
    if d == np.dtype(np.complex128):
        return np.dtype(np.float64)
    raise ValueError(f"Not a complex dtype: {cdtype!r}")


class PiRational:
    """An exact rational multiple of pi: ``(num/den) * pi``
    (``RotationObject::PiRational``, ``qip/src/builder.rs:160-165``)."""

    __slots__ = ("frac",)

    def __init__(self, num: int | Fraction, den: int = 1):
        if isinstance(num, Fraction):
            self.frac = num / den
        else:
            self.frac = Fraction(num, den)

    @property
    def numerator(self) -> int:
        return self.frac.numerator

    @property
    def denominator(self) -> int:
        return self.frac.denominator

    def to_float(self) -> float:
        return float(self.frac) * float(np.pi)

    def __neg__(self) -> "PiRational":
        return PiRational(-self.frac)

    def __truediv__(self, other: int) -> "PiRational":
        return PiRational(self.frac / other)

    def __eq__(self, other) -> bool:
        return isinstance(other, PiRational) and self.frac == other.frac

    def __hash__(self) -> int:
        return hash(("PiRational", self.frac))

    def __repr__(self) -> str:
        return f"PiRational({self.frac.numerator}/{self.frac.denominator} * pi)"


#: A rotation angle: either a float (radians) or an exact pi-rational.
Angle = Union[float, PiRational]


def angle_to_float(theta: Angle) -> float:
    if isinstance(theta, PiRational):
        return theta.to_float()
    return float(theta)
