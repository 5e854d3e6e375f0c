"""The swap pass: a ``SwapOp``'s row pairs, and its cross pairs with them,
on (R, 128) planes.

``row_swap`` applies a set of disjoint row-qubit swap pairs to both planes.
On a CUDA tensor it launches ``row_swap_kernel`` of
``rustqip_tpu_torch/csrc/row_swap.cu`` (in place, one pass for any pair
set, float32 or float64) and counts the launch, or raises; on a CPU tensor
it takes the plain torch version, ``row_swap_reference`` (axis
permutations: one for a reversed contiguous field of span <= 16, else one
per pair), which returns fresh planes. Callers use the returned planes and
must not rely on their input either way.

``cross_row_swap`` takes a ``SwapOp`` whose cross pairs (a row qubit with a
lane qubit) ``apply._cross_swap_applicable`` accepts, with its row pairs,
in one launch of ``cross_row_swap_kernel`` of the same source: in place
when the caller owns the planes, else to fresh planes. On a CPU tensor it
takes ``cross_row_swap_reference`` (``apply._cross_swap_planes``, then
``row_swap_reference``). What bounds each kernel and what its design does
about it is written in the source.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from rustqip_tpu_torch.engine import cuda_build
from rustqip_tpu_torch.engine.apply import (
    _cross_swap_applicable,
    _cross_swap_planes,
    _row_swap_planes,
)
from rustqip_tpu_torch.types import geometry

#: Pairs one launch takes (``RQ_MAX_PAIRS`` in the source).
MAX_PAIRS = 31
#: Pairs, cross and row, one cross launch takes (``RQ_CROSS_MAX_PAIRS``).
CROSS_MAX_PAIRS = 64
#: Lane bits of one segment of the cross kernel: lanes 0..31.
SEG_BITS = 5


def row_swap_reference(n: int, pairs, xr: torch.Tensor, xi: torch.Tensor):
    """The plain torch version: ``apply._row_swap_planes``."""
    return tuple(_row_swap_planes(n, pairs, [xr, xi]))


def _row_bit_pairs(n: int, pairs) -> Tuple[Tuple[int, int], ...]:
    """Qubit pairs -> (low, high) row-index bit pairs (qubit q is row bit
    ``n - m - 1 - q``), checked disjoint and on row qubits."""
    m, _, _ = geometry(n)
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


class CrossPlan(NamedTuple):
    """The host tables of one launch of the cross kernel (``CrossPlan`` in
    the source). Bit q of the flat index ``row * 128 + lane`` is qubit
    ``n - 1 - q``."""

    #: Every pair of the op, cross and row, as (low, high) flat index bits.
    pairs: Tuple[Tuple[int, int], ...]
    #: The cross pairs whose lane bit lies in a segment (below ``SEG_BITS``),
    #: as (flat row bit, lane bit), by row bit: a tile's rows.
    slots: Tuple[Tuple[int, int], ...]
    #: Tiles of the state, 2^(n - 5 - c) for c slots.
    tiles: int
    #: Blocks of work: 32 segments each, 2^(5 - c) tiles.
    units: int


def cross_plan(n: int, cross, rowp) -> CrossPlan:
    """The tables of ``cross_row_swap_kernel`` for a ``SwapOp`` split by
    ``apply._swap_schedule`` into cross pairs (row qubit, lane qubit) on the
    top row qubits and row pairs; raises ``ValueError`` on any other cross
    set or on pairs that are not disjoint."""
    m, _, _ = geometry(n)
    n_m = n - m
    cross = tuple(sorted(tuple(p) for p in cross))
    lanes = {b for _, b in cross}
    if (not _cross_swap_applicable(n, cross) or len(lanes) != len(cross)
            or not all(n_m <= b < n for b in lanes)):
        raise ValueError(f"cross_row_swap: bad cross set {list(cross)} for n={n}")
    rows = _row_bit_pairs(n, rowp)
    if {q for p in rowp for q in p} & {a for a, _ in cross}:
        raise ValueError(f"cross_row_swap: row pairs {list(rowp)} meet the cross pairs")
    pairs = [(n - 1 - b, n - 1 - a) for a, b in cross]
    pairs += [(lo + m, hi + m) for lo, hi in rows]
    if len(pairs) > CROSS_MAX_PAIRS:
        raise ValueError(f"cross_row_swap: {len(pairs)} pairs > {CROSS_MAX_PAIRS}")
    slots = tuple(sorted((hi, lo) for lo, hi in pairs[:len(cross)] if lo < SEG_BITS))
    tiles = 1 << (n - SEG_BITS - len(slots))
    units = -(-tiles >> (SEG_BITS - len(slots)))  # ceil: n = 9 fills part of a unit
    return CrossPlan(tuple(pairs), slots, tiles, units)


def cross_row_swap_reference(n: int, cross, rowp, xr: torch.Tensor, xi: torch.Tensor,
                             inplace: bool = False):
    """The plain torch version: ``apply._cross_swap_planes`` (in place when
    the caller owns the planes, ``inplace``), then ``row_swap_reference``."""
    xr, xi = _cross_swap_planes(n, cross, [xr, xi], inplace)
    if rowp:
        xr, xi = row_swap_reference(n, rowp, xr, xi)
    return xr, xi


def parity_pair_sets(n: int):
    """[(name, qubit pairs)]: the pair sets the kernel is held against its
    plain version on (n >= 14): QFT-n's row field, a reversal of up to 13
    row qubits, scattered pairs, a single pair, and a reversed field that
    reaches the last row bit."""
    m, _, _ = geometry(n)
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


def cross_pair_sets(n: int):
    """[(name, qubit pairs of a SwapOp)]: the sets the cross kernel is held
    against its plain version on (n >= 16). Between them they cover k = 2,
    3, 6 and 7 cross pairs; 1, 2, 4 and 5 of them on the lane bits 0..4 that
    a tile's segment spans (k = 3: lane bits 4, 6, 0, so a tile's row bits
    are not adjacent); ops with and without row pairs: QFT-n's reversal,
    and a QPE-like reversal of all qubits but the last."""
    m, _, _ = geometry(n)
    n_m = n - m
    return [
        ("k2_lane_bits_6_4", [(0, n_m), (1, n - 5)]),
        ("k3_with_rows", [(0, n - 5), (1, n_m), (2, n - 1), (3, n_m - 4), (4, n_m - 1)]),
        ("k6_qpe_reversal", [(j, n - 2 - j) for j in range((n - 1) // 2)]),
        ("k7_cross_only", [(j, n - 1 - j) for j in range(7)]),
        (f"qft{n}_reversal", [(j, n - 1 - j) for j in range(n // 2)]),
    ]


#: The entry points of ``csrc/row_swap.cu`` and their argument types.
ROW_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]
CROSS_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_void_p,
]


def row_swap(n: int, pairs: Sequence[Tuple[int, int]], xr: torch.Tensor, xi: torch.Tensor):
    """Apply row-qubit swap pairs to (R, 128) planes; returns ``(xr, xi)``.

    A CUDA state launches the kernel, in place on contiguous planes (a
    non-contiguous plane is made contiguous first), or raises; a CPU state
    takes ``row_swap_reference``."""
    _, R, C = geometry(n)
    bit_pairs = _row_bit_pairs(n, pairs)
    xr, xi = xr.reshape(R, C).contiguous(), xi.reshape(R, C).contiguous()
    if not cuda_build.on_card("row_swap", xr, xi):
        return row_swap_reference(n, pairs, xr, xi)
    if xr.dtype not in (torch.float32, torch.float64) or C != 128:
        raise TypeError(f"row_swap takes (R, 128) f32/f64 planes, got {xr.dtype}, C={C}")
    if len(bit_pairs) > MAX_PAIRS:
        raise ValueError(f"row_swap: {len(bit_pairs)} pairs > {MAX_PAIRS}")
    if not bit_pairs:
        return xr, xi
    lo = np.array([p[0] for p in bit_pairs], dtype=np.int32)
    hi = np.array([p[1] for p in bit_pairs], dtype=np.int32)
    cuda_build.launch(
        "row_swap", cuda_build.function("row_swap", "rq_row_swap", ROW_ARGTYPES), xr.device,
        xr.data_ptr(), xi.data_ptr(), R, C * xr.element_size(), len(bit_pairs),
        lo.ctypes.data, hi.ctypes.data,
    )
    return xr, xi


def cross_row_swap(n: int, cross, rowp, xr: torch.Tensor, xi: torch.Tensor,
                   inplace: bool = False):
    """Apply a ``SwapOp``'s cross pairs and row pairs (``cross_plan``) to
    (R, 128) planes in one pass; returns ``(xr, xi)``.

    A CUDA state launches ``cross_row_swap_kernel`` once and counts it, or
    raises: in place on the planes when the caller owns them (``inplace``;
    a non-contiguous plane is made contiguous first), else into fresh
    planes, leaving the input as it was. A CPU state takes
    ``cross_row_swap_reference``."""
    _, R, C = geometry(n)
    plan = cross_plan(n, cross, rowp)
    xr, xi = xr.reshape(R, C).contiguous(), xi.reshape(R, C).contiguous()
    if not cuda_build.on_card("cross_row_swap", xr, xi):
        return cross_row_swap_reference(n, cross, rowp, xr, xi, inplace)
    if xr.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"cross_row_swap takes f32/f64 planes, got {xr.dtype}")
    yr, yi = (xr, xi) if inplace else (torch.empty_like(xr), torch.empty_like(xi))
    lo, hi = (np.array([p[j] for p in plan.pairs], dtype=np.int32) for j in (0, 1))
    fbit, lbit = (np.array([s[j] for s in plan.slots] or [0], dtype=np.int32) for j in (0, 1))
    cuda_build.launch(
        "row_swap_cross", cuda_build.function("row_swap", "rq_cross_row_swap", CROSS_ARGTYPES),
        xr.device, xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
        xr.element_size(), len(plan.pairs), lo.ctypes.data, hi.ctypes.data, len(plan.slots),
        fbit.ctypes.data, lbit.ctypes.data, plan.tiles, plan.units,
    )
    return yr, yi
