"""Gate-op IR and validated constructors.

Port of ``rustqip_tpu/ops/matrix_ops.py`` (itself a re-design of the
reference op IR, ``qip-iterators/src/iterators/ops.rs:11-20``, and its
constructors in ``qip/src/state_ops/matrix_ops.rs``). Ops are host-side
descriptions that the engine turns into passes over the (re, im) planes;
only a function op (``FnOp``) reaches torch, whose ``fn`` is evaluated on
int32 index tensors.

Conventions (identical to the reference):
* qubit ``i`` is bit ``n-1-i`` of the state index ("big-endian");
* an op's j-th listed qubit is bit ``k-1-j`` of its sub-matrix row/column;
* dense data is row-major, row = output.
"""

from __future__ import annotations

import itertools
import weakref
from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, List, Sequence, Tuple, Union

import numpy as np
import torch

from rustqip_tpu_torch.errors import CircuitError
from rustqip_tpu_torch.types import Representation
from rustqip_tpu_torch.utils.bits import (
    flip_bits,
    full_to_sub,
    sub_to_full,
    transpose_sparse,
)

SparseRows = Tuple[Tuple[Tuple[int, complex], ...], ...]

#: Widest sparse op accepted (qubits); the JAX package's default cap.
MAX_SPARSE_BITS = 20


@dataclass(frozen=True)
class DenseOp:
    """Dense 2^k x 2^k unitary on ``indices`` (ref ``MatrixOp::Matrix``)."""

    indices: Tuple[int, ...]
    data: np.ndarray  # (2^k, 2^k) complex128, row-major, row = output

    @property
    def num_indices(self) -> int:
        return len(self.indices)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, DenseOp)
            and self.indices == other.indices
            and np.array_equal(self.data, other.data)
        )

    def __hash__(self) -> int:
        return hash(("DenseOp", self.indices, self.data.tobytes()))


@dataclass(frozen=True)
class SparseOp:
    """Sparse unitary stored as per-row ``(col, val)`` entries, big-endian
    normalized (ref ``MatrixOp::SparseMatrix``)."""

    indices: Tuple[int, ...]
    rows: SparseRows

    @property
    def num_indices(self) -> int:
        return len(self.indices)

    def is_permutation(self) -> bool:
        """True if every row has exactly one entry: a permutation with
        phases."""
        return all(len(r) == 1 for r in self.rows)

    def __hash__(self) -> int:
        return hash(("SparseOp", self.indices, self.rows))


@dataclass(frozen=True)
class SwapOp:
    """Swap the first half of ``indices`` with the second half
    (ref ``MatrixOp::Swap``)."""

    indices: Tuple[int, ...]  # a_indices + b_indices, equal halves

    @property
    def half(self) -> int:
        return len(self.indices) // 2

    @property
    def num_indices(self) -> int:
        return len(self.indices)

    def __hash__(self) -> int:
        return hash(("SwapOp", self.indices))


@dataclass(frozen=True)
class ControlOp:
    """Apply ``inner`` when all ``n_ctrl`` leading indices are |1>
    (ref ``MatrixOp::Control``). Nested controls are flattened by
    ``make_control_op``."""

    n_ctrl: int
    indices: Tuple[int, ...]  # control indices + inner op indices
    inner: "MatrixOp"

    @property
    def control_indices(self) -> Tuple[int, ...]:
        return self.indices[: self.n_ctrl]

    @property
    def target_indices(self) -> Tuple[int, ...]:
        return self.indices[self.n_ctrl :]

    @property
    def num_indices(self) -> int:
        return len(self.indices)

    def __hash__(self) -> int:
        return hash(("ControlOp", self.n_ctrl, self.indices, self.inner))


@dataclass(frozen=True)
class PhaseProductOp:
    """A product of small diagonal gates applied as ONE elementwise pass.

    ``terms`` is a tuple of (indices, diag) with diag length
    2^len(indices); diagonal ops commute, so any run composes into a
    single multiply over the state."""

    terms: Tuple[Tuple[Tuple[int, ...], Tuple[complex, ...]], ...]

    @property
    def indices(self) -> Tuple[int, ...]:
        seen = []
        for idx, _ in self.terms:
            for q in idx:
                if q not in seen:
                    seen.append(q)
        return tuple(sorted(seen))

    @property
    def num_indices(self) -> int:
        return len(self.indices)

    def __hash__(self) -> int:
        return hash(("PhaseProductOp", self.terms))


@dataclass(frozen=True)
class ReflectionOp:
    """Householder reflection about the uniform superposition on
    ``indices``: ``D = 2|s><s| - I``, applied blockwise over the
    complement qubits as ``psi -> 2*mean_Q(psi) - psi``. Real, symmetric
    and self-inverse; ``indices`` is normalized sorted."""

    indices: Tuple[int, ...]

    @property
    def num_indices(self) -> int:
        return len(self.indices)

    def __hash__(self) -> int:
        return hash(("ReflectionOp", self.indices))


@dataclass(frozen=True)
class FnOp:
    """Function oracle op: a generalized permutation whose single nonzero
    per row is computed at apply time — ``fn(row) -> (col, val)`` with
    ``row`` an int32 torch tensor (any shape, elementwise), giving matrix
    entries ``M[row, col] = val``. The analog of the reference's lazy
    ``FunctionOpIterator`` (qip-iterators/src/iterators/
    qubit_iterators.rs:223): where ``SparseOp`` tables 2^k entries
    (capped at ``MAX_SPARSE_BITS``), an ``FnOp`` tables nothing — column
    indices and values come from index bit arithmetic over blocks of the
    state, O(1) host memory at any width.

    ``fn`` must be elementwise over int32 tensors (torch operators; the
    JAX package's ``fn`` takes jax arrays) and define a unitary (column
    map bijective, |val| = 1) — like the reference, trusted, not
    validated. ``tag`` is the op's structural identity for plan caching:
    two FnOps with equal tags (and flags) are assumed identical.
    ``self_transpose`` marks XOR-oracle structure (|x>|y> -> theta(x)
    |x>|y ^ f(x)>), for which transpose == self and the inverse is the
    elementwise conjugate. ``diagonal`` asserts ``fn(row) == (row, val)``
    for every row (a phase oracle): the engine then skips the gather —
    one elementwise multiply per pass, and the op is trivially
    self-transpose."""

    indices: Tuple[int, ...]
    fn: Callable
    tag: str
    conjugated: bool = False
    self_transpose: bool = False
    diagonal: bool = False

    @property
    def num_indices(self) -> int:
        return len(self.indices)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, FnOp)
            and self.indices == other.indices
            and self.tag == other.tag
            and self.conjugated == other.conjugated
            and self.self_transpose == other.self_transpose
            and self.diagonal == other.diagonal
        )

    def __hash__(self) -> int:
        return hash(
            ("FnOp", self.indices, self.tag, self.conjugated,
             self.self_transpose, self.diagonal)
        )


MatrixOp = Union[
    DenseOp, SparseOp, SwapOp, ControlOp, PhaseProductOp, FnOp, ReflectionOp
]

#: Largest diagonal materialized per term (2^16 complex values).
DIAG_CAP = 16


def diagonal_of(op) -> "Tuple[Tuple[int, ...], np.ndarray] | None":
    """(indices, 2^k diagonal) if the op is diagonal in the computational
    basis, else None. Controlled-diagonal ops are diagonal."""
    if isinstance(op, DenseOp):
        if op.num_indices > DIAG_CAP:
            return None
        d = np.diagonal(op.data)
        if np.count_nonzero(op.data) == np.count_nonzero(d):
            return op.indices, d.copy()
        return None
    if isinstance(op, SparseOp):
        if op.num_indices > DIAG_CAP:
            return None
        if all(len(r) == 1 and r[0][0] == i for i, r in enumerate(op.rows)):
            return op.indices, np.array([r[0][1] for r in op.rows])
        return None
    if isinstance(op, ControlOp):
        inner = diagonal_of(op.inner)
        if inner is None or op.num_indices > DIAG_CAP:
            return None
        _, d_in = inner
        dim = 1 << op.num_indices
        d = np.ones(dim, dtype=np.complex128)
        d[dim - d_in.size :] = d_in
        return op.indices, d
    return None


# ---------------------------------------------------------------------------
# Constructors (ref qip/src/state_ops/matrix_ops.rs)
# ---------------------------------------------------------------------------


def make_matrix_op(indices: Sequence[int], data) -> DenseOp:
    """Validated dense-op constructor (ref matrix_ops.rs:12)."""
    indices = tuple(int(i) for i in indices)
    n = len(indices)
    if n == 0:
        raise CircuitError("Must supply at least one op index")
    arr = np.asarray(data, dtype=np.complex128)
    if arr.size != 1 << (2 * n):
        raise CircuitError(
            f"Matrix data has {arr.size} entries versus expected 4^{n}"
        )
    arr = arr.reshape(1 << n, 1 << n)
    arr.setflags(write=False)
    return DenseOp(indices, arr)


def make_sparse_matrix_op(
    indices: Sequence[int],
    rows: Sequence[Sequence[Tuple[int, complex]]],
    order: Representation = Representation.BigEndian,
) -> SparseOp:
    """Validated sparse-op constructor with endian normalization
    (ref matrix_ops.rs:32-77)."""
    indices = tuple(int(i) for i in indices)
    n = len(indices)
    if n == 0:
        raise CircuitError("Must supply at least one op index")
    if n > MAX_SPARSE_BITS:
        raise CircuitError(
            f"Sparse op on {n} qubits exceeds the supported width "
            f"({MAX_SPARSE_BITS})"
        )
    if len(rows) != (1 << n):
        raise CircuitError(
            f"Sparse matrix has {len(rows)} rows versus expected 2^{n}"
        )
    for rix, row in enumerate(rows):
        if len(row) == 0:
            raise CircuitError(
                f"All rows of sparse matrix must have data ({rix} is empty)"
            )
    if order is Representation.LittleEndian:
        reordered: List[Sequence[Tuple[int, complex]]] = [()] * len(rows)
        for rix, row in enumerate(rows):
            reordered[flip_bits(n, rix)] = [
                (flip_bits(n, col), val) for col, val in row
            ]
        rows = reordered
    frozen = tuple(
        tuple((int(col), complex(val)) for col, val in row) for row in rows
    )
    return SparseOp(indices, frozen)


def make_sparse_matrix_from_function(
    n: int,
    f: Callable[[int], Sequence[Tuple[int, complex]]],
    order: Representation = Representation.BigEndian,
) -> List[List[Tuple[int, complex]]]:
    """Build sparse rows from a row->entries function (ref matrix_ops.rs:128);
    pass the result to ``make_sparse_matrix_op``."""
    if n > MAX_SPARSE_BITS:
        raise CircuitError(
            f"Sparse function op on {n} qubits exceeds the supported "
            f"width ({MAX_SPARSE_BITS}); see MAX_SPARSE_BITS."
        )
    out: List[List[Tuple[int, complex]]] = []
    for indx in range(1 << n):
        row = flip_bits(n, indx) if order is Representation.LittleEndian else indx
        entries = f(row)
        if order is Representation.LittleEndian:
            entries = [(flip_bits(n, col), val) for col, val in entries]
        out.append([(int(c), complex(v)) for c, v in entries])
    return out


@lru_cache(maxsize=32)
def _reversal_table(w: int, device) -> torch.Tensor:
    """The w-bit reversal of every w-bit value, on ``device``."""
    v = np.arange(1 << w, dtype=np.int64)
    out = np.zeros_like(v)
    for j in range(w):
        out |= ((v >> j) & 1) << (w - 1 - j)
    return torch.as_tensor(out, device=device)


def flip_bits_traced(k: int, v):
    """Elementwise k-bit reversal of an int tensor (or a Python int or
    numpy array): the tensor analog of ``flip_bits``. A tensor takes its
    bits in pieces of at most 16 through one reversal table on its device:
    a few whole-tensor ops a piece, where a bit loop takes four a bit."""
    if not isinstance(v, torch.Tensor):
        out = v - v  # zeros of v's dtype/shape (arrays and ints alike)
        for j in range(k):
            out = out | (((v >> j) & 1) << (k - 1 - j))
        return out
    out = torch.zeros_like(v)
    for lo in range(0, k, 16):
        w = min(16, k - lo)
        piece = ((v >> lo) & ((1 << w) - 1)).long()
        out = out | (_reversal_table(w, v.device)[piece].to(v.dtype) << (k - lo - w))
    return out


# Session-stable serials for auto-generated FnOp tags. id(fn) alone is a
# collision hazard: CPython reuses addresses after GC, and FnOp equality /
# plan-cache fingerprints key on the TAG, not the callable. A
# WeakKeyDictionary keyed by the callable keeps each live callable's serial
# unique and stable for its lifetime without pinning it; a dead callable's
# entry vanishes with it, and its serial is never reissued.
_AUTO_TAG_SERIALS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_AUTO_TAG_COUNTER = itertools.count()


def _auto_tag_serial(fn) -> str:
    """A per-callable token unique across the session (never reused)."""
    try:
        serial = _AUTO_TAG_SERIALS.get(fn)
        if serial is None:
            serial = next(_AUTO_TAG_COUNTER)
            _AUTO_TAG_SERIALS[fn] = serial
        return f"s{serial}"
    except TypeError:  # not weakref-able: fall back to id + code hash
        code = getattr(fn, "__code__", None)
        salt = hash(code.co_code) & 0xFFFFFFFF if code is not None else 0
        return f"i{id(fn):x}.{salt:x}"


def make_fn_op(
    indices: Sequence[int],
    fn: Callable,
    tag: "str | None" = None,
    self_transpose: bool = False,
    diagonal: bool = False,
) -> FnOp:
    """Validated function op constructor (general form).

    ``fn(row) -> (col, val)``: elementwise over int32 torch tensors,
    defining matrix entries ``M[row, col] = val`` in the op's big-endian
    index space — the row -> single-entry orientation of
    ``make_sparse_matrix_from_function`` (ref matrix_ops.rs:128), but
    evaluated at apply time, so nothing caps the width below the 31
    qubits of int32 index arithmetic. ``val`` may be a
    complex or real tensor or a Python number. ``self_transpose=True``
    asserts M^T == M (XOR-oracle structure), enabling
    ``transpose_op``/``invert_op``; ``make_function_op`` sets it for you.
    ``diagonal=True`` asserts ``fn`` is a phase oracle (``col == row``
    always): the engine applies it as one elementwise multiply, no
    gather."""
    indices = tuple(int(i) for i in indices)
    if not indices:
        raise CircuitError("Must supply at least one op index")
    if len(indices) > 31:
        raise CircuitError(
            "FnOp width is capped at 31 qubits (int32 index arithmetic)"
        )
    if tag is None:
        tag = (
            f"{getattr(fn, '__module__', '?')}."
            f"{getattr(fn, '__qualname__', '?')}@{_auto_tag_serial(fn)}"
        )
    return FnOp(
        indices, fn, str(tag), False,
        bool(self_transpose) or bool(diagonal), bool(diagonal),
    )


def make_function_op(
    x_indices: Sequence[int],
    y_indices: Sequence[int],
    f: Callable,
    tag: "str | None" = None,
) -> FnOp:
    """Classical-function oracle |x>|y> -> theta(x) |x>|y XOR f(x)> as a
    function op (ref ``FunctionOpIterator::new``, qubit_iterators.rs:232-253:
    x = row >> output_n, (fx, theta) = f(flip_bits(input_n, x)),
    col = (x << output_n) | (y ^ flip_bits(output_n, fx))).

    ``f(x) -> (fx, theta)`` is elementwise over int32 torch tensors; ``x``
    and ``fx`` are register VALUES in the little-endian across-the-qubit-
    list convention (matching init values and measurement outcomes).
    ``theta`` may be complex (a phase) or 1. XOR structure makes the op its
    own transpose, so ``invert_op`` works (elementwise conjugate)."""
    kx = len(tuple(x_indices))
    ky = len(tuple(y_indices))
    if kx == 0 or ky == 0:
        raise CircuitError("Function op needs non-empty input and output")

    def fn(row):
        x_be = row >> ky
        y = row & ((1 << ky) - 1)
        fx, theta = f(flip_bits_traced(kx, x_be))
        col = (x_be << ky) | (y ^ flip_bits_traced(ky, fx))
        return col, theta

    if tag is None:
        tag = (
            f"xor:{getattr(f, '__module__', '?')}."
            f"{getattr(f, '__qualname__', '?')}@{_auto_tag_serial(f)}:{kx}:{ky}"
        )
    return FnOp(
        tuple(int(i) for i in x_indices) + tuple(int(i) for i in y_indices),
        fn,
        str(tag),
        False,
        True,
    )


def fn_values(val, like: torch.Tensor, conjugated: bool = False):
    """``(vr, vi)`` of an FnOp's values as tensors of ``like``'s dtype and
    device (``vi`` is None for real values); ``val`` may be a tensor or a
    Python number."""
    v = torch.as_tensor(val, device=like.device)
    if v.is_complex():
        vi = v.imag.to(like.dtype)
        return v.real.to(like.dtype), (-vi if conjugated else vi)
    return v.to(like.dtype), None


def make_reflection_op(indices: Sequence[int]) -> ReflectionOp:
    """Validated constructor for ``2|s><s| - I`` on ``indices``."""
    indices = tuple(sorted(int(i) for i in indices))
    if not indices:
        raise CircuitError("Must supply at least one op index")
    if len(set(indices)) != len(indices):
        raise CircuitError("Reflection indices must be unique")
    return ReflectionOp(indices)


def make_swap_op(a_indices: Sequence[int], b_indices: Sequence[int]) -> SwapOp:
    """Validated swap-op constructor (ref matrix_ops.rs:84)."""
    a = tuple(int(i) for i in a_indices)
    b = tuple(int(i) for i in b_indices)
    if not a or not b:
        raise CircuitError("Need at least 1 swap index for a and b")
    if len(a) != len(b):
        raise CircuitError(
            "Swap must be performed on two sets of indices of equal length, "
            f"found {len(a)} vs {len(b)}"
        )
    return SwapOp(a + b)


def make_control_op(c_indices: Sequence[int], op: MatrixOp) -> ControlOp:
    """Validated control-op constructor; flattens nested controls
    (ref matrix_ops.rs:103-121)."""
    c = tuple(int(i) for i in c_indices)
    if not c:
        raise CircuitError("Must supply at least one control index")
    if isinstance(op, ControlOp):
        return ControlOp(len(c) + op.n_ctrl, c + op.indices, op.inner)
    return ControlOp(len(c), c + op.indices, op)


def from_reals(reals: Sequence[float]) -> np.ndarray:
    """Real data -> complex array (ref matrix_ops.rs:204)."""
    return np.asarray(reals, dtype=np.float64).astype(np.complex128)


def from_tuples(tuples: Sequence[Tuple[float, float]]) -> np.ndarray:
    """(re, im) tuples -> complex array (ref matrix_ops.rs:215)."""
    return np.array([complex(re, im) for re, im in tuples], dtype=np.complex128)


# ---------------------------------------------------------------------------
# Op algebra (ref matrix_ops.rs:152-201)
# ---------------------------------------------------------------------------


def op_fingerprint(op: MatrixOp) -> tuple:
    """Structural, exact-bytes fingerprint of an op (compile caching)."""
    if isinstance(op, DenseOp):
        return ("D", op.indices, op.data.tobytes())
    if isinstance(op, SparseOp):
        return ("S", op.indices, op.rows)
    if isinstance(op, SwapOp):
        return ("W", op.indices)
    if isinstance(op, ControlOp):
        return ("C", op.n_ctrl, op.indices, op_fingerprint(op.inner))
    if isinstance(op, PhaseProductOp):
        return ("P", op.terms)
    if isinstance(op, FnOp):
        return ("F", op.indices, op.tag, op.conjugated,
                op.self_transpose, op.diagonal)
    if isinstance(op, ReflectionOp):
        return ("R", op.indices)
    raise TypeError(f"Unknown op {op!r}")


def conj_op(op: MatrixOp) -> MatrixOp:
    """Elementwise conjugate (ref matrix_ops.rs:157)."""
    if isinstance(op, PhaseProductOp):
        return PhaseProductOp(
            tuple(
                (idx, tuple(complex(v).conjugate() for v in d))
                for idx, d in op.terms
            )
        )
    if isinstance(op, DenseOp):
        return DenseOp(op.indices, np.conj(op.data))
    if isinstance(op, SparseOp):
        return SparseOp(
            op.indices,
            tuple(tuple((c, complex(v).conjugate()) for c, v in r) for r in op.rows),
        )
    if isinstance(op, (SwapOp, ReflectionOp)):
        return op  # real matrices
    if isinstance(op, ControlOp):
        return ControlOp(op.n_ctrl, op.indices, conj_op(op.inner))
    if isinstance(op, FnOp):
        return FnOp(
            op.indices, op.fn, op.tag, not op.conjugated,
            op.self_transpose, op.diagonal,
        )
    raise TypeError(f"Unknown op {op!r}")


def transpose_op(op: MatrixOp) -> MatrixOp:
    """Matrix transpose (ref matrix_ops.rs:182)."""
    if isinstance(op, (PhaseProductOp, SwapOp, ReflectionOp)):
        return op  # diagonal / symmetric
    if isinstance(op, DenseOp):
        return DenseOp(op.indices, op.data.T.copy())
    if isinstance(op, SparseOp):
        rows = transpose_sparse([list(r) for r in op.rows])
        return SparseOp(
            op.indices, tuple(tuple((c, complex(v)) for c, v in r) for r in rows)
        )
    if isinstance(op, ControlOp):
        return ControlOp(op.n_ctrl, op.indices, transpose_op(op.inner))
    if isinstance(op, FnOp):
        if op.self_transpose or op.diagonal:
            return op
        raise CircuitError(
            "Cannot transpose a general function op (the inverse column "
            "map is not derivable from fn). Use make_function_op (XOR "
            "oracles are their own transpose) or a SparseOp."
        )
    raise TypeError(f"Unknown op {op!r}")


def invert_op(op: MatrixOp) -> MatrixOp:
    """Unitary inverse = conjugate transpose (ref matrix_ops.rs:152)."""
    return conj_op(transpose_op(op))


def op_to_dense(op: MatrixOp) -> np.ndarray:
    """Materialize the op's own 2^k x 2^k matrix (in its listed index order)."""
    k = op.num_indices
    dim = 1 << k
    if isinstance(op, DenseOp):
        return np.asarray(op.data, dtype=np.complex128)
    if isinstance(op, SparseOp):
        mat = np.zeros((dim, dim), dtype=np.complex128)
        for row, entries in enumerate(op.rows):
            for col, val in entries:
                mat[row, col] = val
        return mat
    if isinstance(op, SwapOp):
        h = op.half
        mat = np.zeros((dim, dim), dtype=np.complex128)
        for row in range(dim):
            lo = row & ((1 << h) - 1)
            hi = row >> h
            mat[row, (lo << h) | hi] = 1.0
        return mat
    if isinstance(op, ControlOp):
        inner = op_to_dense(op.inner)
        mat = np.eye(dim, dtype=np.complex128)
        off = dim - inner.shape[0]
        mat[off:, off:] = inner
        return mat
    if isinstance(op, PhaseProductOp):
        srt = op.indices
        diag = np.ones(dim, dtype=np.complex128)
        s = np.arange(dim)
        for tidx, tdiag in op.terms:
            kt = len(tidx)
            t = np.zeros(dim, dtype=np.int64)
            for j, q in enumerate(tidx):
                bit = (s >> (k - 1 - srt.index(q))) & 1
                t |= bit << (kt - 1 - j)
            diag = diag * np.asarray(tdiag)[t]
        return np.diag(diag)
    if isinstance(op, ReflectionOp):
        return (2.0 / dim) * np.ones((dim, dim), dtype=np.complex128) - np.eye(
            dim, dtype=np.complex128
        )
    if isinstance(op, FnOp):
        if k > MAX_SPARSE_BITS:
            raise CircuitError(
                f"Cannot materialize a {k}-qubit function op (cap "
                f"{MAX_SPARSE_BITS}); the apply path needs no "
                "materialization at any width."
            )
        rows = torch.arange(dim, dtype=torch.int32)
        cols, vals = op.fn(rows)
        cols = torch.as_tensor(cols).to(torch.int64).expand(dim).numpy()
        vr, vi = fn_values(vals, rows.double(), op.conjugated)
        v = vr.expand(dim).numpy().astype(np.complex128)
        if vi is not None:
            v = v + 1j * vi.expand(dim).numpy()
        mat = np.zeros((dim, dim), dtype=np.complex128)
        mat[np.arange(dim), cols] = v
        return mat
    raise TypeError(f"Unknown op {op!r}")


def select_matrix_coords(
    n: int, indices: Sequence[int], row: int, col: int
) -> Tuple[int, int]:
    """Project full-matrix (row, col) onto an op's sub-matrix coordinates
    (ref matrix_ops.rs:226-242)."""
    return full_to_sub(n, list(indices), row), full_to_sub(n, list(indices), col)


def expand_op_matrix(
    mat: np.ndarray, positions: Sequence[int], k: int
) -> np.ndarray:
    """Embed a 2^p x 2^p matrix acting on qubit ``positions`` into the full
    2^k x 2^k matrix over qubits 0..k-1 (kron + bit permutation)."""
    p = len(positions)
    big = np.kron(mat, np.eye(1 << (k - p), dtype=mat.dtype))
    order = list(positions) + [i for i in range(k) if i not in positions]
    idx = np.arange(1 << k)
    y = np.zeros_like(idx)
    for j, q in enumerate(order):
        bit = (idx >> (k - 1 - q)) & 1
        y |= bit << (k - 1 - j)
    return big[np.ix_(y, y)]


def make_op_matrix(n: int, op: MatrixOp) -> np.ndarray:
    """Full 2^n x 2^n matrix the op induces on an n-qubit state
    (ref matrix_ops.rs:246). Debug only."""
    dim = 1 << n
    small = op_to_dense(op)
    k = op.num_indices
    out = np.zeros((dim, dim), dtype=np.complex128)
    mat_indices = list(op.indices)
    for row in range(dim):
        sub_row = full_to_sub(n, mat_indices, row)
        for sub_col in range(1 << k):
            val = small[sub_row, sub_col]
            if val != 0:
                out[row, sub_to_full(n, mat_indices, sub_col, row)] = val
    return out
