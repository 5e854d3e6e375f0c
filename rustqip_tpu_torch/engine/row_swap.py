"""The row-swap pass: row-row swap pairs of a ``SwapOp`` on (R, 128) planes.

``row_swap`` applies a set of disjoint row-qubit swap pairs to both planes.
On a CUDA tensor it launches the Hopper kernel of
``rustqip_tpu_torch/csrc/row_swap.cu`` (in place, one pass for any pair
set, float32 or float64) and counts the launch, or raises; on a CPU tensor
it takes the plain torch version, ``row_swap_reference`` (axis
permutations: one for a reversed contiguous field of span <= 16, else one
per pair), which returns fresh planes. Callers use the returned planes and
must not rely on their input either way. What bounds the kernel and what
its design does about it is written at the top of its source.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Sequence, Tuple

import numpy as np
import torch

from rustqip_tpu_torch.engine import cuda_build
from rustqip_tpu_torch.engine.apply import _geometry, _row_swap_planes

#: Kernel launches, counted by ``row_swap`` where it launches and nowhere
#: else.
LAUNCHES: Counter = Counter()
#: Pairs one launch takes (``RQ_MAX_PAIRS`` in the source).
MAX_PAIRS = 31


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def row_swap_reference(n: int, pairs, xr: torch.Tensor, xi: torch.Tensor):
    """The plain torch version: ``apply._row_swap_planes``."""
    return tuple(_row_swap_planes(n, pairs, [xr, xi]))


def _row_bit_pairs(n: int, pairs) -> Tuple[Tuple[int, int], ...]:
    """Qubit pairs -> (low, high) row-index bit pairs (qubit q is row bit
    ``n - m - 1 - q``), checked disjoint and on row qubits."""
    m, _, _ = _geometry(n)
    n_m = n - m
    out = []
    seen = set()
    for a, b in pairs:
        if a == b or not (0 <= a < n_m and 0 <= b < n_m) or {a, b} & seen:
            raise ValueError(f"row_swap: bad pair set {list(pairs)} for n={n}")
        seen |= {a, b}
        pa, pb = n_m - 1 - a, n_m - 1 - b
        out.append((min(pa, pb), max(pa, pb)))
    return tuple(out)


def parity_pair_sets(n: int):
    """[(name, qubit pairs)]: the pair sets the kernel is held against its
    plain version on (n >= 14): QFT-n's row field, a reversal of up to 13
    row qubits, scattered pairs, a single pair, and a reversed field that
    reaches the last row bit."""
    m, _, _ = _geometry(n)
    n_m = n - m
    span = min(13, n_m)
    sets = [
        ("qft_row_field", [(j, n - 1 - j) for j in range(n // 2) if n - 1 - j < n_m]),
        (f"span{span}_reversal", [(t, span - 1 - t) for t in range(span // 2)]),
        ("scattered", [(0, 5), (2, n_m - 1), (3, 4)]),
        ("single_pair", [(1, n_m - 2)]),
        ("field_to_last_row_bit", [(n_m - 6 + t, n_m - 1 - t) for t in range(3)]),
    ]
    return [(name, pairs) for name, pairs in sets if pairs]


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("row_swap")
        fn = lib.rq_row_swap
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def row_swap(n: int, pairs: Sequence[Tuple[int, int]], xr: torch.Tensor, xi: torch.Tensor):
    """Apply row-qubit swap pairs to (R, 128) planes; returns ``(xr, xi)``.

    A CUDA state launches the kernel, in place on contiguous planes (a
    non-contiguous plane is made contiguous first), or raises; a CPU state
    takes ``row_swap_reference``."""
    _, R, C = _geometry(n)
    xr, xi = xr.reshape(R, C), xi.reshape(R, C)
    bit_pairs = _row_bit_pairs(n, pairs)
    if xr.device.type == "cpu":
        return row_swap_reference(n, pairs, xr, xi)
    if xr.device.type != "cuda":
        raise ValueError(f"row_swap: no kernel for device {xr.device}")
    if xr.device != xi.device or xr.dtype != xi.dtype:
        raise ValueError("row_swap: planes must share one device and dtype")
    if xr.dtype not in (torch.float32, torch.float64) or C != 128:
        raise TypeError(f"row_swap takes (R, 128) f32/f64 planes, got {xr.dtype}, C={C}")
    if len(bit_pairs) > MAX_PAIRS:
        raise ValueError(f"row_swap: {len(bit_pairs)} pairs > {MAX_PAIRS}")
    if not bit_pairs:
        return xr, xi
    xr, xi = xr.contiguous(), xi.contiguous()
    if xr.data_ptr() % 16 or xi.data_ptr() % 16:
        raise ValueError("row_swap needs 16-byte aligned planes")
    lo = np.array([p[0] for p in bit_pairs], dtype=np.int32)
    hi = np.array([p[1] for p in bit_pairs], dtype=np.int32)
    with torch.cuda.device(xr.device):
        err = _lib().rq_row_swap(
            xr.data_ptr(), xi.data_ptr(), R, C * xr.element_size(), len(bit_pairs),
            lo.ctypes.data, hi.ctypes.data,
            torch.cuda.current_stream(xr.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"row_swap kernel launch failed: CUDA error {err}")
    LAUNCHES["row_swap"] += 1
    return xr, xi
