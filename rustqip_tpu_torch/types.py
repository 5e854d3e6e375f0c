"""Precision / dtype handling, the plane format and bit-order representation.

Port of ``rustqip_tpu/types.py`` without JAX. The reference parameterizes
everything over a ``Precision`` trait covering f32/f64
(``qip/src/types.rs:6-13``); here the analog is a dtype choice:

* ``complex64``  — f32 (re, im) planes; the window kernel's domain.
* ``complex128`` — f64 planes; always the plain torch paths (the JAX
  package never sends f64 to its kernel either).

The default precision is ``complex64``: the port has no global x64 switch
to follow, so builders that need f64 ask for it (``dtype="f64"``).

The plane format, a 2^n state as (re, im) planes of shape ``(R, 128)``, is
defined here once and every layer reads it from here: ``geometry``,
``row_segment_shape`` and the conversions between a flat complex state and
its planes (``state_tensor``, ``split_state``, ``join_planes``,
``fresh_plane``).
"""

from __future__ import annotations

import enum
from fractions import Fraction
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

#: Low-qubit column block = 2^7 = 128 lanes: the canonical (R, 128) plane
#: view shared by the engine, the window kernel and the measurements.
MINOR_QUBITS = 7

#: Most state elements a blocked plain pass (the outcome probabilities, the
#: collapse, the cross swap, the reflection) works on at once, a power of
#: two: its temporaries stay at 64 MiB of float32 whatever n is, so a
#: 32-qubit state (32 GiB of float32 planes) runs with little more than
#: itself on an 80 GB card.
PASS_BLOCK = 1 << 24


# ---------------------------------------------------------------------------
# The plane format: a 2^n state as (re, im) planes of shape (R, C)
# ---------------------------------------------------------------------------


def geometry(n: int) -> Tuple[int, int, int]:
    """``(m, R, C)`` of a 2^n state's plane view: ``m`` lane qubits (the
    last ``m`` qubits), ``R = 2^(n - m)`` rows of ``C = 2^m`` lanes."""
    m = min(n, MINOR_QUBITS)
    return m, 1 << (n - m), 1 << m


def row_segment_shape(n: int, m: int, high: Sequence[int]) -> Tuple[int, ...]:
    """Row-space shape exposing each high qubit as its own 2-axis:
    (seg, 2, seg, 2, ..., seg)."""
    shape: List[int] = []
    prev = 0
    for q in high:
        shape.append(1 << (q - prev))
        shape.append(2)
        prev = q + 1
    shape.append(1 << ((n - m) - prev))
    return tuple(shape)


#: The complex dtype a real state is promoted to.
_COMPLEX_OF = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def state_tensor(state, device) -> torch.Tensor:
    """A complex tensor of ``state``: a tensor stays on its own device, a
    numpy array (or anything else ``np.asarray`` takes) goes to ``device``."""
    if isinstance(state, torch.Tensor):
        x = state
    else:
        x = torch.as_tensor(np.ascontiguousarray(state), device=device)
    if x.is_complex():
        return x.resolve_conj()
    if x.dtype not in _COMPLEX_OF:
        raise TypeError(f"a state must be complex64/128 or float32/64, got {x.dtype}")
    return x.to(_COMPLEX_OF[x.dtype])


def split_state(n: int, state, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fresh contiguous (R, C) (re, im) planes of a flat complex 2^n state,
    from one read of it: the planes are the two halves of one new buffer,
    so passes that update planes in place never reach the caller's state."""
    x = state_tensor(state, device)
    if x.numel() != 1 << n:
        raise ValueError(f"a state of {n} qubits has {1 << n} amplitudes, got {x.numel()}")
    _, R, C = geometry(n)
    planes = torch.view_as_real(x.reshape(R, C)).permute(2, 0, 1).contiguous()
    return planes[0], planes[1]


def join_planes(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """The flat complex state of (re, im) planes."""
    return torch.complex(re, im).reshape(-1)


def fresh_plane(x: torch.Tensor, R: int, C: int) -> torch.Tensor:
    """A contiguous (R, C) copy of ``x``, for a pass that works in place
    on a state its caller keeps."""
    return x.reshape(R, C).clone(memory_format=torch.contiguous_format)


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
