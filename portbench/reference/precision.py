"""The arithmetic a reference runs in: float64 (the reference) or TF32 (the
control: float32 with every product's operands rounded to TF32, as a
tensor-core product in TF32 rounds them, and sums in float32)."""

from __future__ import annotations

import numpy as np
import torch

EXACT = "float64"
TF32 = "tf32"
ARITHS = (EXACT, TF32)


def round_tf32_np(x: np.ndarray) -> np.ndarray:
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` rounds."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return bits.view(np.float32)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``round_tf32_np`` of a float32 or complex64 tensor (real and
    imaginary parts each); a new tensor."""
    if x.is_complex():
        return torch.view_as_complex(round_tf32(torch.view_as_real(x)))
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def complex_dtype(arith: str) -> torch.dtype:
    if arith not in ARITHS:
        raise ValueError(f"unknown arithmetic {arith!r}")
    return torch.complex128 if arith == EXACT else torch.complex64


def operand(x: torch.Tensor, arith: str) -> torch.Tensor:
    """``x`` as a product's operand in ``arith``."""
    return round_tf32(x) if arith == TF32 else x
