"""Host-side gate plans and the plain torch passes over (re, im) planes.

Port of the parts of ``rustqip_tpu/engine/apply.py`` that the (re, im)
execution domain uses: the dense block plan (``_dense_plan``), the
phase-product monomial plan (``_phase_plan``/``_phase_mul_ri``), the
gather passes of wide sparse ops (``_sparse_apply_planes``) and function
ops (``_fn_apply_planes``), control masks, the structured swap passes and
the reflection pass. Plans are numpy and cached; the passes are torch on
whatever device the planes live on. The plane format itself (the
``(R, C)`` geometry, the state-to-planes conversions) is ``types``'; the
state-vector API over these passes is ``real_apply``'s.

Index conventions are the reference's: qubit q is bit ``n-1-q`` of the
state index; in the (R, C) view row qubits are ``q < n - m`` (row bit
``n-m-1-q``) and column ("lane") qubits are ``q >= n - m`` (col bit
``n-1-q``).
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
import torch

from rustqip_tpu_torch import types as _types
from rustqip_tpu_torch.errors import CircuitError
from rustqip_tpu_torch.ops.matrix_ops import (
    ControlOp,
    DenseOp,
    FnOp,
    PhaseProductOp,
    ReflectionOp,
    SparseOp,
    SwapOp,
    expand_op_matrix,
    fn_values,
)
from rustqip_tpu_torch.types import fresh_plane, geometry, row_segment_shape
from rustqip_tpu_torch.utils.bits import move_bits

#: Largest op support materialized as a dense matrix on the host.
DENSE_CAP = 10


def _const(arr, like: torch.Tensor) -> torch.Tensor:
    """A host numpy constant as a tensor of ``like``'s dtype and device."""
    return torch.as_tensor(np.asarray(arr), dtype=like.dtype, device=like.device)


def _sorted_dense(indices: Tuple[int, ...], mat: np.ndarray):
    """Reorder a gate matrix so its qubit order is ascending."""
    order = tuple(sorted(indices))
    if order == tuple(indices):
        return order, np.asarray(mat)
    k = len(indices)
    positions = tuple(order.index(q) for q in indices)
    return order, expand_op_matrix(np.asarray(mat), positions, k)


@lru_cache(maxsize=512)
def _dense_plan(n: int, indices: Tuple[int, ...], mat_key):
    """Host-side plan for a dense apply: expanded numpy blocks + shapes.
    ``mat_key`` is (bytes, shape) so plans cache across identical gates."""
    mat = np.frombuffer(mat_key[0], dtype=np.complex128).reshape(mat_key[1])
    m, R, C = geometry(n)
    order, mat_s = _sorted_dense(indices, mat)
    high = [q for q in order if q < n - m]
    low = [q for q in order if q >= n - m]
    lpos = [q - (n - m) for q in low]
    h, l = len(high), len(low)
    dl = 1 << l
    if h == 0:
        return ("low", expand_op_matrix(mat_s, lpos, m), R, C)
    # Block decomposition: U = sum_{hj,hi} |hj><hi| (x) U_low[hj,hi].
    blocks = {}
    for hj in range(1 << h):
        for hi in range(1 << h):
            sub = mat_s[hj * dl : (hj + 1) * dl, hi * dl : (hi + 1) * dl]
            if not np.any(sub):
                continue
            if l == 0:
                blocks[(hj, hi)] = ("scalar", complex(sub[0, 0]))
            elif np.array_equal(sub, sub[0, 0] * np.eye(dl)):
                # v * I on the column space: a plain scaling.
                blocks[(hj, hi)] = ("scalar", complex(sub[0, 0]))
            else:
                blocks[(hj, hi)] = ("mat", expand_op_matrix(sub, lpos, m))
    seg_shape = row_segment_shape(n, m, high)
    return ("blocks", blocks, seg_shape, h, R, C)


def _mat_key(mat: np.ndarray):
    arr = np.ascontiguousarray(mat, dtype=np.complex128)
    return (arr.tobytes(), arr.shape)


def _walsh_coeffs(tidx, d: np.ndarray):
    """Monomial (Moebius) decomposition of a diagonal's complex log:
    ``(angle_coeffs, logmag_coeffs)``; the second is None for unit-modulus
    diagonals."""
    kt = len(tidx)
    dd = np.asarray(d, dtype=np.complex128)
    mags = np.abs(dd)
    if np.any(mags == 0):
        raise CircuitError(
            "PhaseProductOp terms must have nonzero diagonal entries"
        )
    phi = np.angle(dd).copy()
    unit = bool(np.allclose(mags, 1.0, rtol=0, atol=1e-14))
    lm = None if unit else np.log(mags)

    def moebius(v):
        v = v.copy()
        for j in range(kt):
            stride = 1 << (kt - 1 - j)
            for base in range(1 << kt):
                if base & stride:
                    v[base] -= v[base & ~stride]
        out = {}
        for mask in range(1 << kt):
            c = v[mask]
            if abs(c) < 1e-15:
                continue
            subset = tuple(
                tidx[j] for j in range(kt) if (mask >> (kt - 1 - j)) & 1
            )
            out[subset] = out.get(subset, 0.0) + float(c)
        return out

    return moebius(phi), (moebius(lm) if lm is not None else None)


@lru_cache(maxsize=256)
def _phase_plan(n: int, terms):
    """Host plan for a PhaseProductOp: monomials split into constant,
    row-only, col-only and mixed (row-subset, col-subset, coeff) groups —
    one group set for the phase angle, an optional second for the
    log-magnitude of non-unit-modulus diagonals."""
    m, _, _ = geometry(n)
    n_m = n - m

    def empty():
        return [0.0, {}, {}, []]  # const, row_monos, col_monos, mixed

    angle_g = empty()
    mag_g = empty()
    has_mag = False

    def add(groups, subset, c):
        rq = tuple(q for q in subset if q < n_m)
        cq = tuple(q for q in subset if q >= n_m)
        if not subset:
            groups[0] += c
        elif not cq:
            groups[1][rq] = groups[1].get(rq, 0.0) + c
        elif not rq:
            groups[2][cq] = groups[2].get(cq, 0.0) + c
        else:
            groups[3].append((rq, cq, c))

    for tidx, tdiag in terms:
        acoef, mcoef = _walsh_coeffs(tidx, np.asarray(tdiag))
        for subset, c in acoef.items():
            add(angle_g, subset, c)
        if mcoef is not None:
            has_mag = True
            for subset, c in mcoef.items():
                add(mag_g, subset, c)

    def freeze(g):
        return (g[0], tuple(g[1].items()), tuple(g[2].items()), tuple(g[3]))

    return freeze(angle_g), (freeze(mag_g) if has_mag else None)


def _iota_bit_helpers(n: int, like: torch.Tensor):
    """(rows, cols, row_bit, col_bit, mono) over the (R, C) index vectors
    — the one definition of the row/col bit convention used by every
    monomial evaluator below."""
    m, R, C = geometry(n)
    n_m = n - m
    rows = torch.arange(R, device=like.device)
    cols = torch.arange(C, device=like.device)

    def row_bit(q):
        return ((rows >> (n_m - 1 - q)) & 1).to(like.dtype)

    def col_bit(q):
        return ((cols >> (n - 1 - q)) & 1).to(like.dtype)

    def mono(bits, coeff=1.0):
        acc = None
        for b in bits:
            acc = b if acc is None else acc * b
        return acc * coeff

    return rows, cols, row_bit, col_bit, mono


def _sep_monomial_vals(n: int, groups, like: torch.Tensor):
    """(row_val (R,), col_val (C,), mixed) from one monomial group set."""
    const, row_monos, col_monos, mixed = groups
    _, R, C = geometry(n)
    _, _, row_bit, col_bit, mono = _iota_bit_helpers(n, like)
    row_val = torch.full((R,), const, dtype=like.dtype, device=like.device)
    for rq, c in row_monos:
        row_val = row_val + mono([row_bit(q) for q in rq], c)
    col_val = torch.zeros((C,), dtype=like.dtype, device=like.device)
    for cq, c in col_monos:
        col_val = col_val + mono([col_bit(q) for q in cq], c)
    return row_val, col_val, mixed


def _eval_bilinear_2d(n: int, groups, like: torch.Tensor) -> torch.Tensor:
    """One monomial group set over the (R, C) view; mixed monomials form
    one (R, M) @ (M, C) matmul."""
    _, _, row_bit, col_bit, mono = _iota_bit_helpers(n, like)
    row_val, col_val, mixed = _sep_monomial_vals(n, groups, like)
    val = row_val[:, None] + col_val[None, :]
    if mixed:
        U = torch.stack(
            [mono([row_bit(q) for q in rq]) for rq, _, _ in mixed], dim=1
        )
        V = torch.stack(
            [mono([col_bit(q) for q in cq], c) for _, cq, c in mixed], dim=1
        )
        val = val + U @ V.T
    return val


#: Mixed row x col monomial count above which the phase factor takes the
#: bilinear matmul form (the JAX package's threshold).
MIXED_SELECT_CAP = 24


def _phase_mul_ri(n: int, op, r2d: torch.Tensor, i2d: torch.Tensor):
    """Multiply (re, im) planes by a PhaseProductOp's diagonal."""
    m, R, C = geometry(n)
    n_m = n - m
    angle_g, mag_g = _phase_plan(n, op.terms)
    rows, cols, _, _, _ = _iota_bit_helpers(n, r2d)

    if mag_g is not None or len(angle_g[3]) > MIXED_SELECT_CAP:
        angle = _eval_bilinear_2d(n, angle_g, r2d)
        ca, sa = torch.cos(angle), torch.sin(angle)
        if mag_g is not None:
            mag = torch.exp(_eval_bilinear_2d(n, mag_g, r2d))
            ca, sa = ca * mag, sa * mag
        return r2d * ca - i2d * sa, r2d * sa + i2d * ca

    row_angle, col_angle, mixed = _sep_monomial_vals(n, angle_g, r2d)
    rc, rs = torch.cos(row_angle)[:, None], torch.sin(row_angle)[:, None]
    out_r = r2d * rc - i2d * rs
    out_i = r2d * rs + i2d * rc
    cc, cs = torch.cos(col_angle)[None, :], torch.sin(col_angle)[None, :]
    out_r, out_i = out_r * cc - out_i * cs, out_r * cs + out_i * cc
    np_dtype = np.float32 if r2d.dtype == torch.float32 else np.float64
    for rq, cq, c in mixed:
        rmask = torch.ones((R,), dtype=torch.bool, device=r2d.device)
        for q in rq:
            rmask = rmask & (((rows >> (n_m - 1 - q)) & 1) == 1)
        cmask = torch.ones((C,), dtype=torch.bool, device=r2d.device)
        for q in cq:
            cmask = cmask & (((cols >> (n - 1 - q)) & 1) == 1)
        mask = rmask[:, None] & cmask[None, :]
        pc = float(np.float64(np.cos(c)).astype(np_dtype))
        ps = float(np.float64(np.sin(c)).astype(np_dtype))
        out_r, out_i = (
            torch.where(mask, out_r * pc - out_i * ps, out_r),
            torch.where(mask, out_r * ps + out_i * pc, out_i),
        )
    return out_r, out_i


#: Largest number of state elements one gather block covers: a block's
#: int64 source indices and the fn's temporaries stay a few hundred MiB,
#: where whole-state (R, C) index arrays would be 1-2 GiB each at n = 28.
GATHER_BLOCK = 1 << 24


def _row_blocks(R: int, C: int):
    """``(r0, r1)`` row ranges of at most ``GATHER_BLOCK`` elements."""
    step = max(1, GATHER_BLOCK // C)
    for r0 in range(0, R, step):
        yield r0, min(R, r0 + step)


@lru_cache(maxsize=256)
def _bit_runs(n: int, indices: Tuple[int, ...]):
    """How the (R, C) view's row and column bits map onto the op-local
    big-endian index (bit ``k-1-j`` is qubit ``indices[j]``), as
    ``move_bits`` runs ``(view_bit, local_bit, length)`` of consecutive
    bits: one run for a contiguous, ordered stretch of qubits. Returns the
    row runs, the column runs, and the row and column masks of the op's
    bits."""
    k = len(indices)
    m, _, _ = geometry(n)
    n_m = n - m
    runs = {True: [], False: []}
    for j in reversed(range(k)):
        q = indices[j]
        on_row = q < n_m
        vb, lb = (n_m - 1 - q) if on_row else (n - 1 - q), k - 1 - j
        rr = runs[on_row]
        if rr and rr[-1][0] + rr[-1][2] == vb and rr[-1][1] + rr[-1][2] == lb:
            rr[-1][2] += 1
        else:
            rr.append([vb, lb, 1])
    row_mask = sum(((1 << ln) - 1) << vb for vb, _, ln in runs[True])
    col_mask = sum(((1 << ln) - 1) << vb for vb, _, ln in runs[False])
    return (tuple(map(tuple, runs[True])), tuple(map(tuple, runs[False])),
            row_mask, col_mask)


def _inverse_runs(runs):
    """The same runs read the other way: local bits back to view bits."""
    return tuple((lb, vb, ln) for vb, lb, ln in runs)


def _local_rows(n: int, indices, rows: torch.Tensor, cols: torch.Tensor):
    """The op-local big-endian row index at each (row, col) position of a
    row block (the dtype of ``rows``), and the row/col masks of the op's
    bits."""
    row_runs, col_runs, row_mask, col_mask = _bit_runs(n, tuple(indices))
    return (move_bits(rows, row_runs)[:, None] | move_bits(cols, col_runs)[None, :],
            row_mask, col_mask)


def _gather_planes(re2d, im2d, src_row, src_col):
    """``re2d[src_row, src_col]`` and the same of ``im2d`` by flat index."""
    C = re2d.shape[1]
    src = src_row.to(torch.int64) * C + src_col
    return re2d.reshape(-1)[src], im2d.reshape(-1)[src]


@lru_cache(maxsize=64)
def _sparse_plan(n: int, indices: Tuple[int, ...], rows):
    """Host plan for a gather-based sparse apply of any width
    (``apply._sparse_plan``): each sub-row's entries padded to the max
    nonzeros-per-row ``T``, as (T, 2^k) column and value tables, and the
    spread of an op-local column index onto the row/col bits of the (R, C)
    view."""
    k = len(indices)
    m, _, _ = geometry(n)
    n_m = n - m
    dim = 1 << k
    max_nnz = max(len(r) for r in rows)
    cols_t = np.zeros((max_nnz, dim), np.int64)
    vre_t = np.zeros((max_nnz, dim), np.float64)
    vim_t = np.zeros((max_nnz, dim), np.float64)
    for row, entries in enumerate(rows):
        for t, (c, v) in enumerate(entries):
            cols_t[t, row] = c
            vre_t[t, row] = v.real
            vim_t[t, row] = v.imag
    s = np.arange(dim, dtype=np.int64)
    spread_row = np.zeros(dim, np.int64)
    spread_col = np.zeros(dim, np.int64)
    for j, q in enumerate(indices):
        bit = (s >> (k - 1 - j)) & 1
        if q < n_m:
            spread_row |= bit << (n_m - 1 - q)
        else:
            spread_col |= bit << (n - 1 - q)
    return max_nnz, cols_t, vre_t, vim_t, spread_row, spread_col


def _sparse_apply_planes(n: int, op, re2d: torch.Tensor, im2d: torch.Tensor):
    """Gather-based sparse apply on (R, C) planes: ``T`` gather +
    multiply-accumulate passes (one for a permutation oracle), in row
    blocks of ``GATHER_BLOCK`` elements. Returns fresh planes."""
    max_nnz, cols_t, vre_t, vim_t, spread_row, spread_col = _sparse_plan(
        n, tuple(op.indices), op.rows
    )
    _, R, C = geometry(n)
    dev = re2d.device

    def table(a, dtype=torch.int64):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    cols_j, srow, scol = table(cols_t), table(spread_row), table(spread_col)
    vre = table(vre_t, re2d.dtype)
    vim = table(vim_t, re2d.dtype) if np.any(vim_t) else None
    cols = torch.arange(C, dtype=torch.int64, device=dev)
    out_r, out_i = torch.empty_like(re2d), torch.empty_like(im2d)
    for r0, r1 in _row_blocks(R, C):
        rows = torch.arange(r0, r1, dtype=torch.int64, device=dev)
        pat, row_mask, col_mask = _local_rows(n, op.indices, rows, cols)
        base_row = (rows & ~row_mask)[:, None]
        base_col = (cols & ~col_mask)[None, :]
        acc_r = acc_i = None
        for t in range(max_nnz):
            sc = cols_j[t][pat]
            gr, gi = _gather_planes(re2d, im2d, base_row | srow[sc],
                                    base_col | scol[sc])
            vr = vre[t][pat]
            tr, ti = gr * vr, gi * vr
            if vim is not None and np.any(vim_t[t]):
                vi = vim[t][pat]
                tr, ti = tr - gi * vi, ti + gr * vi
            acc_r = tr if acc_r is None else acc_r + tr
            acc_i = ti if acc_i is None else acc_i + ti
        out_r[r0:r1], out_i[r0:r1] = acc_r, acc_i
    return out_r, out_i


def _fn_apply_planes(n: int, op, re2d: torch.Tensor, im2d: torch.Tensor):
    """Function-op apply on (R, C) planes (``apply._fn_apply_planes``): per
    row block, ``op.fn`` on the int32 op-local row indices gives each
    position's source column and value, then ONE gather + multiply; a
    ``diagonal`` op skips the gather (one elementwise multiply). Nothing is
    tabled: O(block) memory at any width. Returns fresh planes."""
    _, R, C = geometry(n)
    dev = re2d.device
    row_runs, col_runs, _, _ = _bit_runs(n, tuple(op.indices))
    to_row, to_col = _inverse_runs(row_runs), _inverse_runs(col_runs)
    cols = torch.arange(C, dtype=torch.int32, device=dev)
    out_r, out_i = torch.empty_like(re2d), torch.empty_like(im2d)
    for r0, r1 in _row_blocks(R, C):
        rows = torch.arange(r0, r1, dtype=torch.int32, device=dev)
        pat, row_mask, col_mask = _local_rows(n, op.indices, rows, cols)
        sc, val = op.fn(pat)
        if op.diagonal:
            gr, gi = re2d[r0:r1], im2d[r0:r1]
        else:
            sc = torch.as_tensor(sc, device=dev)
            gr, gi = _gather_planes(
                re2d, im2d,
                (rows & ~row_mask)[:, None] | move_bits(sc, to_row),
                (cols & ~col_mask)[None, :] | move_bits(sc, to_col),
            )
        vr, vi = fn_values(val, re2d, op.conjugated)
        if vi is None:
            out_r[r0:r1], out_i[r0:r1] = gr * vr, gi * vr
        else:
            out_r[r0:r1] = gr * vr - gi * vi
            out_i[r0:r1] = gi * vr + gr * vi
    return out_r, out_i


def _control_mask_2d(
    n: int, ctrl: Sequence[int], R: int, C: int, device
) -> torch.Tensor:
    """Bool (R, C) mask: True where all control qubits are |1>."""
    n_m = R.bit_length() - 1
    rows = torch.arange(R, device=device)
    cols = torch.arange(C, device=device)
    mask_r = torch.ones((R,), dtype=torch.bool, device=device)
    mask_c = torch.ones((C,), dtype=torch.bool, device=device)
    for q in ctrl:
        if q < n_m:
            mask_r = mask_r & (((rows >> (n_m - 1 - q)) & 1) == 1)
        else:
            mask_c = mask_c & (((cols >> (n - 1 - q)) & 1) == 1)
    return mask_r[:, None] & mask_c[None, :]


def _col_relabel_table(n: int, layout) -> np.ndarray:
    """(C,) gather table: output col slot s holds the input bit at col
    position ``layout[s]`` (positions are qubit ids >= n-m)."""
    m, _, C = geometry(n)
    cols = np.arange(C)
    src = np.zeros(C, dtype=np.int64)
    for s, q in enumerate(layout):
        bit = (cols >> (m - 1 - s)) & 1
        src |= bit << (n - 1 - q)
    return src


def _split_swap_pairs(n: int, op):
    """(cross_pairs, same_pairs): cross pairs exchange a row qubit with a
    column qubit; same pairs stay within one side."""
    m, _, _ = geometry(n)
    n_m = n - m
    cross, same = [], []
    for a, b in zip(op.indices[: op.half], op.indices[op.half :]):
        lo, hi = (a, b) if a < b else (b, a)
        if lo < n_m <= hi:
            cross.append((lo, hi))
        else:
            same.append((lo, hi))
    return cross, same


def _owned_plane(x: torch.Tensor, R: int, C: int, inplace: bool) -> torch.Tensor:
    """The contiguous (R, C) plane a pass updates in place: ``x`` itself
    when its caller owns it (``inplace``), else a fresh copy, so that ``x``
    stays as it was."""
    if inplace:
        return x.reshape(R, C).contiguous()
    return fresh_plane(x, R, C)


@lru_cache(maxsize=64)
def _cross_swap_perm(n: int, cross: Tuple[Tuple[int, int], ...]) -> np.ndarray:
    """The flat (2^k * C,) source index of each element of one row group:
    for a middle row index j the 2^k rows {i * (R >> k) + j} are closed
    under the exchange of the top k row bits with the low k lane bits, and
    each group moves the same way. The table is the JAX package's staged
    pass (col relabel, block transpose, col relabel back) applied to the
    indices of one group."""
    m, _, C = geometry(n)
    n_m = n - m
    k = len(cross)
    staged = [b for _, b in cross]
    parked = [q for q in range(n_m, n) if q not in staged]
    layout1 = parked + staged
    slot_of = {q: n_m + s for s, q in enumerate(layout1)}
    layout2 = [n - k + staged.index(p) if p in staged else slot_of[p]
               for p in range(n_m, n)]
    g = np.arange((1 << k) * C).reshape(1 << k, C)[:, _col_relabel_table(n, layout1)]
    g = g.reshape(1 << k, C >> k, 1 << k).transpose(2, 1, 0).reshape(1 << k, C)
    return np.ascontiguousarray(g[:, _col_relabel_table(n, layout2)].reshape(-1))


def _cross_swap_planes(n: int, cross, planes, inplace: bool = False):
    """Exchange k (row qubit, col qubit) pairs: the top k row bits with
    the low k lane bits after the lanes are relabelled. Requires the cross
    row qubits to be exactly the top k rows (``_cross_swap_applicable``).
    Row groups (``_cross_swap_perm``) move in chunks of ``PASS_BLOCK``
    elements, each read, permuted and written back: in place when the
    caller owns the planes (``inplace``), else on copies. Exact: elements
    only move."""
    m, R, C = geometry(n)
    cross = tuple(sorted(cross))
    k = len(cross)
    if [a for a, _ in cross] != list(range(k)):
        raise CircuitError("cross swap needs the top row qubits")
    G = 1 << k
    step = max(1, _types.PASS_BLOCK // (G * C))
    outs = []
    for x in planes:
        x = _owned_plane(x, R, C, inplace)
        perm = torch.as_tensor(_cross_swap_perm(n, cross), device=x.device)
        groups = x.view(G, R >> k, C)
        for j0 in range(0, R >> k, step):
            blk = groups[:, j0:j0 + step]
            src = blk.transpose(0, 1).reshape(-1, G * C)
            blk.copy_(src[:, perm].reshape(-1, G, C).transpose(0, 1))
        outs.append(x)
    return outs


def _cross_swap_applicable(n: int, cross) -> bool:
    m, _, _ = geometry(n)
    k = len(cross)
    if k < 2 or k > min(n - m, m):
        return False
    return sorted(a for a, _ in cross) == list(range(k))


def _split_same_pairs(n: int, same):
    """(row_pairs, col_pairs, mixed): same-side pairs by side; ``mixed``
    collects row<->col pairs that fall back to dense passes."""
    m, _, _ = geometry(n)
    n_m = n - m
    rowp, colp, mixed = [], [], []
    for a, b in same:
        if b < n_m:
            rowp.append((a, b))
        elif a >= n_m:
            colp.append((a, b))
        else:
            mixed.append((a, b))
    return rowp, colp, mixed


#: Largest contiguous row-bit field reversed by one axis permutation
#: (rank = span + 3, so at most 19 axes: under torch's 25-dim limit).
_FIELD_REVERSAL_MAX_SPAN = 16


def _row_swap_planes(n: int, pairs, planes):
    """Row-row swap pairs as axis permutations (pure copies). Pairs that
    reverse one contiguous row-bit field (QFT's bit reversal) collapse
    into ONE permutation."""
    m, R, C = geometry(n)
    n_m = n - m
    fused = _row_field_reversal(n_m, pairs)
    outs = []
    for x in planes:
        x = x.reshape(R, C)
        if fused is not None:
            pre, span = fused
            post = R // (pre << span)
            shape = (pre,) + (2,) * span + (post, C)
            perm = (0,) + tuple(range(span, 0, -1)) + (span + 1, span + 2)
            x = x.reshape(shape).permute(perm).reshape(R, C)
        else:
            for a, b in pairs:
                pa, pb = n_m - 1 - a, n_m - 1 - b  # a < b -> pa > pb
                shape = (R >> (pa + 1), 2, 1 << (pa - pb - 1), 2, 1 << pb, C)
                x = x.reshape(shape).permute(0, 3, 2, 1, 4, 5).reshape(R, C)
        outs.append(x)
    return outs


def _row_field_reversal(n_m: int, pairs):
    """(pre, span) when the pairs reverse one contiguous row-bit field,
    else None."""
    if len(pairs) < 2:
        return None
    qubits = sorted(q for p in pairs for q in p)
    lo, hi = qubits[0], qubits[-1]
    if hi >= n_m:
        return None
    span = hi - lo + 1
    if span > _FIELD_REVERSAL_MAX_SPAN:
        return None
    want = {(lo + t, hi - t) for t in range(span // 2)}
    if {tuple(sorted(p)) for p in pairs} != want:
        return None
    return 1 << lo, span


def _col_swap_planes(n: int, pairs, planes):
    """Col-col swap pairs as ONE lane relabel (a 128-entry gather)."""
    m, R, C = geometry(n)
    n_m = n - m
    layout = list(range(n_m, n))
    for a, b in pairs:
        sa, sb = a - n_m, b - n_m
        layout[sa], layout[sb] = layout[sb], layout[sa]
    t = _col_relabel_table(n, layout)
    return [
        x.reshape(R, C)[:, torch.as_tensor(t, device=x.device)] for x in planes
    ]


def _swap_schedule(n: int, op):
    """Split a SwapOp into (cross, row_pairs, col_pairs, dense_pairs)."""
    cross, same = _split_swap_pairs(n, op)
    if not _cross_swap_applicable(n, cross):
        same = same + cross
        cross = []
    rowp, colp, mixed = _split_same_pairs(n, same)
    return cross, rowp, colp, mixed


#: Most axes one reshape of a CUDA tensor may have (torch's limit).
MAX_RESHAPE_RANK = 25


def _reflection_plan(n: int, indices: Tuple[int, ...]):
    """Plan for one reflection pass on the (R, C) view: the optional
    (C, C) 0/1 lane-sum matrix and the row-axis runs reshapes (sum over
    the op's row-qubit bits as keepdim reductions over contiguous bit
    runs). One reshape exposes every run (rank = #runs + 1) when that fits
    ``MAX_RESHAPE_RANK``; otherwise the member runs are summed in stages,
    each stage's reshape exposing a group of them with the bits between
    merged, so no reshape passes the limit. Returns ``(B, stages)``, each
    stage ``(shape, axes)``."""
    m, _R, C = geometry(n)
    n_m = n - m
    col_q = [q for q in indices if q >= n_m]
    row_q = set(q for q in indices if q < n_m)
    B = None
    if col_q:
        drop = 0
        for q in col_q:
            drop |= 1 << (n - 1 - q)
        keep = (C - 1) & ~drop
        cols = np.arange(C)
        B = ((cols[:, None] & keep) == (cols[None, :] & keep)).astype(
            np.float64
        )
    if not row_q:
        return B, ()
    runs: List[List] = []  # [bit-run length, in-op?]
    for pos in range(n_m):
        member = pos in row_q
        if runs and runs[-1][1] == member:
            runs[-1][0] += 1
        else:
            runs.append([1, member])
    members = [i for i, (_, mem) in enumerate(runs) if mem]
    if len(runs) + 1 <= MAX_RESHAPE_RANK:
        groups = [members]
    else:
        # a group of g runs takes at most 2g + 2 axes
        g = (MAX_RESHAPE_RANK - 2) // 2
        groups = [members[i : i + g] for i in range(0, len(members), g)]
    stages = []
    for group in groups:
        shape: List[int] = []
        axes: List[int] = []
        merged = 1
        for i, (L, _) in enumerate(runs):
            if i in group:
                if merged > 1:
                    shape.append(merged)
                    merged = 1
                axes.append(len(shape))
                shape.append(1 << L)
            else:
                merged <<= L
        if merged > 1:
            shape.append(merged)
        stages.append((tuple(shape) + (C,), tuple(axes)))
    return B, tuple(stages)


def _reflection_sum_2d(n: int, indices, x2d: torch.Tensor):
    """``(summed, shape)``: the sum of ``x2d`` over the given qubits' bits,
    broadcast within lanes (col bits, one matmul against a 0/1 matrix) and
    keepdim-reduced over row bits in the last stage's view ``shape`` (the
    view a caller takes of a full plane to broadcast against it; None when
    no row bits are involved and ``summed`` is already (R, C))."""
    B, stages = _reflection_plan(n, tuple(indices))
    s = x2d
    if B is not None:
        s = s @ _const(B, x2d)
    for shape, axes in stages[:-1]:
        s = torch.sum(s.reshape(shape), dim=axes, keepdim=True)
        s = s.expand(shape).reshape(x2d.shape)
    if stages:
        shape, axes = stages[-1]
        return torch.sum(s.reshape(shape), dim=axes, keepdim=True), shape
    return s, None


def _apply_reflection_2d(n: int, op, x2d: torch.Tensor, inplace: bool = False) -> torch.Tensor:
    """``psi -> 2*mean_Q(psi) - psi`` blockwise on the (R, C) view; the
    operator is real, so each (re, im) plane takes the same transform.
    The sum runs over the op's row bits first (a keepdim reduction: one
    row of 128 lanes for an op on every row qubit) and then over its
    lanes (one matmul against a 0/1 matrix on the reduced tensor; for
    lane qubits alone, in row blocks of ``PASS_BLOCK`` elements); the
    plane is then updated as ``x.mul_(-1).add_(scale * s)``: in place
    when the caller owns it (``inplace``), else on a copy. A plan of more
    than one reshape stage (more than 24 row-bit runs) takes the staged
    sums of ``_reflection_sum_2d``, whose temporaries are plane-sized."""
    _, R, C = geometry(n)
    B, stages = _reflection_plan(n, tuple(op.indices))
    scale = 2.0 / (1 << op.num_indices)
    if len(stages) > 1:
        s, shape = _reflection_sum_2d(n, op.indices, x2d)
        out = (scale * s - x2d.reshape(shape)).reshape(R, C)
        return _owned_plane(x2d, R, C, True).copy_(out) if inplace else out
    x = _owned_plane(x2d, R, C, inplace)
    lanes = _const(B, x) if B is not None else None
    if not stages:
        step = max(1, _types.PASS_BLOCK // C)
        for r0 in range(0, R, step):
            blk = x[r0:r0 + step]
            s = blk @ lanes
            blk.mul_(-1).add_(s, alpha=scale)
        return x
    (shape, axes), = stages
    view = x.view(shape)
    s = torch.sum(view, dim=axes, keepdim=True)
    if lanes is not None:
        s = s @ lanes
    view.mul_(-1).add_(s, alpha=scale)
    return x


def _reindex_op(op, new_indices: Tuple[int, ...]):
    """``op`` moved onto ``new_indices``, position for position (JAX
    ``apply.py``:1026)."""
    if isinstance(op, PhaseProductOp):
        remap = dict(zip(op.indices, new_indices))
        return PhaseProductOp(
            tuple(
                (tuple(remap[q] for q in tidx), tdiag)
                for tidx, tdiag in op.terms
            )
        )
    if isinstance(op, DenseOp):
        return DenseOp(tuple(new_indices), op.data)
    if isinstance(op, SparseOp):
        return SparseOp(tuple(new_indices), op.rows)
    if isinstance(op, SwapOp):
        return SwapOp(tuple(new_indices))
    if isinstance(op, ControlOp):
        n_inner = op.inner.num_indices
        inner = _reindex_op(op.inner, new_indices[op.n_ctrl:][:n_inner])
        return ControlOp(op.n_ctrl, tuple(new_indices), inner)
    if isinstance(op, FnOp):
        # ``fn`` works in the op's own k-bit index space, keyed by the
        # position of each qubit in ``indices``: a positional reindex keeps
        # its meaning exactly.
        return FnOp(
            tuple(new_indices), op.fn, op.tag, op.conjugated,
            op.self_transpose, op.diagonal,
        )
    if isinstance(op, ReflectionOp):
        # |s><s| is symmetric under permutations of its qubits: re-sort.
        return ReflectionOp(tuple(sorted(new_indices)))
    raise TypeError(f"Unknown op {op!r}")
