"""The monomial pass: an op whose matrix has exactly one nonzero in every
row and column, run as a permutation of amplitudes with phases, on
(R, 128) planes.

``plan_of`` is the host check, run once per op at compile time
(``real_apply.compile_sweeps``) and kept on the op: a ``DenseOp``, or a
``ControlOp`` whose inner op is a ``DenseOp`` or a ``SparseOp``, of at most
``MAX_TARGETS`` target qubits, whose matrix is monomial and not diagonal,
becomes a ``MonomialPlan``: where each amplitude of a segment comes from,
its phase, and the control bits. The check is exact: entries are compared
to 0, never within a tolerance. A diagonal keeps its routes (a phase
product, a window's ``diag`` step), and so does every op a window takes.

A segment is the 2^k amplitudes that the op's k target bits span with
every other bit fixed; the op maps each segment whose control bits are all
1 onto itself and leaves the others alone. ``monomial_pass`` reads each such
segment once and writes it once. On a CUDA tensor whose caller's kernel
rule allows it (``admission.kernel_policy``, read by
``real_apply.apply_op_ri``) it launches ``monomial_pass_kernel`` of
``rustqip_tpu_torch/csrc/monomial_pass.cu`` once and counts it, or raises;
otherwise it takes the plain torch version, ``monomial_pass_reference``,
which gathers and scatters blocks of ``types.PASS_BLOCK`` elements. Both
work in place when the caller owns the planes (``inplace``), and otherwise
on copies, leaving the input as it was. The kernel's products round one by
one, as the plain version's do, so the two agree bit for bit. What bounds
the kernel and what its design does about it is written in the source.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from rustqip_tpu_torch import types as _types
from rustqip_tpu_torch.engine import cuda_build
from rustqip_tpu_torch.ops.matrix_ops import ControlOp, DenseOp, SparseOp
from rustqip_tpu_torch.types import fresh_plane, geometry

#: Most target qubits of a monomial op: a segment of 2^12 amplitudes, 32 KB
#: of float32 planes in the kernel's shared memory.
MAX_TARGETS = 12
#: Index bits of the kernel's smallest tile (2^11 amplitudes): segments
#: smaller than that share a tile with the segments that differ from them
#: in the lowest bits that are neither targets nor controls.
TILE_BITS = 11
#: Tile index bits that the first of the kernel's two table levels reads
#: (``RQ_MONO_LO_BITS``); the second reads the rest, up to ``MAX_TARGETS``.
LO_BITS = 7

#: The entry point of ``csrc/monomial_pass.cu`` and its argument types.
ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int,
]


def _deposit(values: np.ndarray, positions) -> np.ndarray:
    """Bit j of each value moved to bit ``positions[j]`` (int64)."""
    out = np.zeros(values.shape, dtype=np.int64)
    for j, p in enumerate(positions):
        out |= ((values >> j) & 1) << p
    return out


@dataclass(eq=False)
class MonomialPlan:
    """One monomial op on an n-qubit state. The flat index of an amplitude
    is ``row * 128 + lane``, and qubit q is its bit n - 1 - q; bit b of a
    segment-local index is flat bit ``tbits[b]``."""

    n: int
    #: The targets' flat index bits, ascending.
    tbits: Tuple[int, ...]
    #: The controls' flat index bits, ascending; the op acts where all are 1.
    cbits: Tuple[int, ...]
    #: (2^k,) int64: the segment-local index whose amplitude lands at each
    #: place.
    src: np.ndarray
    #: (2^k,) complex128: the factor of the amplitude that lands at each
    #: place; None where every factor is 1.
    phase: Optional[np.ndarray]
    _dev: dict = field(default_factory=dict, repr=False)

    @property
    def k(self) -> int:
        return len(self.tbits)

    @property
    def cval(self) -> int:
        """The control bits, all 1, as a flat index."""
        return sum(1 << b for b in self.cbits)

    def free_bits(self) -> List[int]:
        """The flat bits that are neither targets nor controls, ascending."""
        taken = set(self.tbits) | set(self.cbits)
        return [b for b in range(self.n) if b not in taken]

    def touched(self) -> int:
        """Amplitudes the op can change: every segment its controls select."""
        return 1 << (self.n - len(self.cbits))

    def least_bytes(self, itemsize: int) -> int:
        """One read and one write of both planes of every touched amplitude."""
        return self.touched() * 2 * itemsize * 2

    def offsets(self) -> np.ndarray:
        """(2^k,) int64: the flat offset of each segment-local index."""
        return _deposit(np.arange(1 << self.k, dtype=np.int64), self.tbits)

    def tile(self) -> Tuple[List[int], int, List[int]]:
        """The kernel's tile: its index bits (flat bits, ascending: the
        targets and the lowest free bits, ``TILE_BITS`` at least where the
        state has them), the mask of its index bits that are targets, and
        the free bits that number the tiles."""
        free = self.free_bits()
        extra = max(0, min(TILE_BITS - self.k, len(free)))
        bits = sorted(self.tbits + tuple(free[:extra]))
        tmask = sum(1 << i for i, b in enumerate(bits) if b in self.tbits)
        return bits, tmask, free[extra:]

    def tables(self, device) -> torch.Tensor:
        """The kernel's tables (``csrc/monomial_pass.cu``), as 32-bit words
        on ``device``, uploaded once."""
        key = str(torch.device(device))
        got = self._dev.get(key)
        if got is None:
            got = self._dev[key] = torch.as_tensor(self._table_words(), device=device)
        return got

    def _table_words(self) -> np.ndarray:
        bits, tmask, _ = self.tile()
        tpos = [i for i in range(len(bits)) if tmask >> i & 1]
        rank = {i: r for r, i in enumerate(tpos)}

        def level(first: int, width: int):
            """The flat offset and the segment-local index of each value of
            the tile index bits first .. first + width."""
            idx = range(first, min(len(bits), first + width))
            vals = np.arange(1 << width, dtype=np.int64)
            local = np.zeros(1 << width, dtype=np.int64)
            for j, i in enumerate(idx):
                if i in rank:
                    local |= ((vals >> j) & 1) << rank[i]
            return _deposit(vals, [bits[i] for i in idx]), local

        (off_lo, sl_lo), (off_hi, sl_hi) = level(0, LO_BITS), level(LO_BITS, MAX_TARGETS - LO_BITS)
        parts = [off_lo, off_hi, sl_lo, sl_hi, _deposit(self.src, tpos)]
        words = np.concatenate([p.astype(np.uint32) for p in parts])
        if self.phase is not None:
            ph = np.stack([self.phase.real, self.phase.imag]).astype(np.float32)
            words = np.concatenate([words, ph.reshape(-1).view(np.uint32)])
        return words.view(np.int32)


def _monomial(inner) -> "Tuple[np.ndarray, np.ndarray] | None":
    """(perm, vals) of a monomial matrix in its own index order (column j
    goes to row perm[j] times vals[j]), or None: exactly one nonzero entry
    in every row and column, compared to 0."""
    dim = 1 << inner.num_indices
    if isinstance(inner, DenseOp):
        mat = np.asarray(inner.data)
        nz = mat != 0
        if not (np.all(nz.sum(axis=0) == 1) and np.all(nz.sum(axis=1) == 1)):
            return None
        perm = nz.argmax(axis=0)
        return perm, mat[perm, np.arange(dim)].astype(np.complex128)
    perm = np.full(dim, -1, dtype=np.int64)
    vals = np.zeros(dim, dtype=np.complex128)
    for row, entries in enumerate(inner.rows):
        nonzero = [(int(c), v) for c, v in entries if v != 0]
        if len(nonzero) != 1 or perm[nonzero[0][0]] >= 0:
            return None
        perm[nonzero[0][0]], vals[nonzero[0][0]] = row, nonzero[0][1]
    return perm, vals


def _check(n: int, op) -> "MonomialPlan | None":
    if isinstance(op, DenseOp):
        inner, targets, ctrl = op, tuple(op.indices), ()
    elif isinstance(op, ControlOp) and isinstance(op.inner, (DenseOp, SparseOp)):
        inner, targets, ctrl = op.inner, tuple(op.target_indices), tuple(op.control_indices)
    else:
        return None
    k = len(targets)
    if not 0 < k <= MAX_TARGETS:
        return None
    found = _monomial(inner)
    if found is None:
        return None
    perm, vals = found
    if np.array_equal(perm, np.arange(1 << k)):
        return None  # diagonal
    tbits = tuple(sorted(n - 1 - q for q in targets))
    local = _matrix_to_local(k, targets, tbits, n)
    src = np.empty(1 << k, dtype=np.int64)
    phase = np.empty(1 << k, dtype=np.complex128)
    src[local[perm]] = local
    phase[local[perm]] = vals
    return MonomialPlan(n, tbits, tuple(sorted(n - 1 - q for q in ctrl)), src,
                        None if np.all(phase == 1) else phase)


def _matrix_to_local(k: int, targets, tbits, n: int) -> np.ndarray:
    """(2^k,) the segment-local index of each matrix index."""
    i = np.arange(1 << k, dtype=np.int64)
    out = np.zeros(1 << k, dtype=np.int64)
    for j, q in enumerate(targets):
        out |= ((i >> (k - 1 - j)) & 1) << tbits.index(n - 1 - q)
    return out


def plan_of(n: int, op) -> "MonomialPlan | None":
    """The monomial plan of ``op`` on an n-qubit state, or None; worked out
    once per op and n and kept on the op."""
    if not isinstance(op, (DenseOp, ControlOp)):
        return None
    plans = getattr(op, "_monomial_plans", None)
    if plans is None:
        plans = {}
        object.__setattr__(op, "_monomial_plans", plans)
    if n not in plans:
        plans[n] = _check(n, op)
    return plans[n]


def monomial_pass_reference(n: int, plan: MonomialPlan, xr: torch.Tensor, xi: torch.Tensor):
    """The plain torch version, in place on contiguous (R, C) planes: the
    touched segments in blocks of ``types.PASS_BLOCK`` elements, each
    gathered from its sources, multiplied by its phases (each product
    rounded, then the sum) and scattered back. Exact where every phase is
    1: amplitudes only move."""
    fr, fi = xr.view(-1), xi.view(-1)
    dev = fr.device
    free = plan.free_bits()
    off = torch.as_tensor(plan.offsets(), device=dev)
    src_off = off[torch.as_tensor(plan.src, device=dev)]
    if plan.phase is not None:
        pr = torch.as_tensor(plan.phase.real, dtype=fr.dtype, device=dev)
        pi = torch.as_tensor(plan.phase.imag, dtype=fr.dtype, device=dev)
    shifts = torch.arange(len(free), dtype=torch.int64, device=dev)
    fbits = torch.as_tensor(free, dtype=torch.int64, device=dev)
    nseg = 1 << len(free)
    step = max(1, _types.PASS_BLOCK >> plan.k)
    for s0 in range(0, nseg, step):
        seg = torch.arange(s0, min(nseg, s0 + step), dtype=torch.int64, device=dev)
        base = (((seg[:, None] >> shifts) & 1) << fbits).sum(dim=1, keepdim=True) + plan.cval
        gr, gi = fr[base + src_off], fi[base + src_off]
        if plan.phase is not None:
            gr, gi = gr * pr - gi * pi, gr * pi + gi * pr
        dst = base + off
        fr[dst], fi[dst] = gr, gi
    return xr, xi


def monomial_pass(n: int, plan: MonomialPlan, xr: torch.Tensor, xi: torch.Tensor,
                  inplace: bool = False, kernel: bool = True):
    """Apply ``plan`` to (R, 128) planes; returns ``(xr, xi)``: the planes
    themselves when the caller owns them (``inplace``; a non-contiguous
    plane is made contiguous first), else fresh ones, the input left as it
    was. ``kernel`` (the caller's kernel rule) and CUDA planes launch the
    kernel, or raise; otherwise ``monomial_pass_reference`` runs."""
    _, R, C = geometry(n)
    if plan.n != n:
        raise ValueError(f"monomial_pass: a plan for n={plan.n} on n={n}")
    if inplace:
        xr, xi = xr.reshape(R, C).contiguous(), xi.reshape(R, C).contiguous()
    else:
        xr, xi = fresh_plane(xr, R, C), fresh_plane(xi, R, C)
    if not (kernel and cuda_build.on_card("monomial_pass", xr, xi)):
        return monomial_pass_reference(n, plan, xr, xi)
    if xr.dtype != torch.float32:
        raise TypeError(f"monomial_pass takes float32 planes, got {xr.dtype}")
    bits, tmask, outer = plan.tile()
    tables = plan.tables(xr.device)
    outer_arr = np.array(outer or [0], dtype=np.int32)
    cuda_build.launch(
        "monomial_pass", cuda_build.function("monomial_pass", "rq_monomial_pass", ARGTYPES),
        xr.device, xr.data_ptr(), xi.data_ptr(), tables.data_ptr(), len(bits), plan.k, tmask,
        len(outer), outer_arr.ctypes.data, plan.cval, int(plan.phase is not None),
        int(bits[:2] == [0, 1]),
    )
    return xr, xi
