"""Host-side gate plans and the plane helpers of the plain torch paths.

Port of the parts of ``rustqip_tpu/engine/apply.py`` that the (re, im)
execution domain uses: the canonical ``(R, C)`` geometry (``_geometry``),
the dense block plan (``_dense_plan``), the phase-product monomial plan
(``_phase_plan``/``_phase_mul_ri``), control masks, the structured swap
passes and the reflection pass. Plans are numpy and cached; the passes are
torch on whatever device the planes live on. The JAX package's complex-array
path (``_apply_dense``, ``_t_apply``, ...) is not carried over: the port has
one execution domain, (re, im) planes of shape ``(R, 128)`` in f32 or f64.

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

from rustqip_tpu_torch.errors import CircuitError
from rustqip_tpu_torch.ops.matrix_ops import expand_op_matrix
from rustqip_tpu_torch.types import MINOR_QUBITS

#: Largest op support materialized as a dense matrix on the host.
DENSE_CAP = 10


def _geometry(n: int) -> Tuple[int, int, int]:
    m = min(n, MINOR_QUBITS)
    return m, 1 << (n - m), 1 << m


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


def _row_segment_shape(n: int, m: int, high: Sequence[int]) -> Tuple[int, ...]:
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


@lru_cache(maxsize=512)
def _dense_plan(n: int, indices: Tuple[int, ...], mat_key):
    """Host-side plan for a dense apply: expanded numpy blocks + shapes.
    ``mat_key`` is (bytes, shape) so plans cache across identical gates."""
    mat = np.frombuffer(mat_key[0], dtype=np.complex128).reshape(mat_key[1])
    m, R, C = _geometry(n)
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
    seg_shape = _row_segment_shape(n, m, high)
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
    m, _, _ = _geometry(n)
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
    m, R, C = _geometry(n)
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
    _, R, C = _geometry(n)
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
    m, R, C = _geometry(n)
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
    m, _, C = _geometry(n)
    cols = np.arange(C)
    src = np.zeros(C, dtype=np.int64)
    for s, q in enumerate(layout):
        bit = (cols >> (m - 1 - s)) & 1
        src |= bit << (n - 1 - q)
    return src


def _split_swap_pairs(n: int, op):
    """(cross_pairs, same_pairs): cross pairs exchange a row qubit with a
    column qubit; same pairs stay within one side."""
    m, _, _ = _geometry(n)
    n_m = n - m
    cross, same = [], []
    for a, b in zip(op.indices[: op.half], op.indices[op.half :]):
        lo, hi = (a, b) if a < b else (b, a)
        if lo < n_m <= hi:
            cross.append((lo, hi))
        else:
            same.append((lo, hi))
    return cross, same


def _cross_swap_planes(n: int, cross, planes):
    """Exchange k (row qubit, col qubit) pairs in one staged pass:
    col-relabel, block transpose (top-k row bits <-> low-k col bits),
    col-relabel back. Requires the cross row qubits to be exactly the top
    k rows (``_cross_swap_applicable``)."""
    m, R, C = _geometry(n)
    n_m = n - m
    cross = sorted(cross)
    k = len(cross)
    if [a for a, _ in cross] != list(range(k)):
        raise CircuitError("cross swap needs the top row qubits")
    cols_all = list(range(n_m, n))
    staged = [b for _, b in cross]
    parked = [q for q in cols_all if q not in staged]
    layout1 = parked + staged
    slot_of = {q: n_m + s for s, q in enumerate(layout1)}
    layout2 = []
    for s in range(m):
        p = n_m + s
        if p in staged:
            layout2.append(n - k + staged.index(p))
        else:
            layout2.append(slot_of[p])
    t1 = _col_relabel_table(n, layout1)
    t2 = _col_relabel_table(n, layout2)
    outs = []
    for x in planes:
        x = x.reshape(R, C)[:, torch.as_tensor(t1, device=x.device)]
        x = (
            x.reshape(1 << k, R >> k, C >> k, 1 << k)
            .permute(3, 1, 2, 0)
            .reshape(R, C)
        )
        outs.append(x[:, torch.as_tensor(t2, device=x.device)])
    return outs


def _cross_swap_applicable(n: int, cross) -> bool:
    m, _, _ = _geometry(n)
    k = len(cross)
    if k < 2 or k > min(n - m, m):
        return False
    return sorted(a for a, _ in cross) == list(range(k))


def _split_same_pairs(n: int, same):
    """(row_pairs, col_pairs, mixed): same-side pairs by side; ``mixed``
    collects row<->col pairs that fall back to dense passes."""
    m, _, _ = _geometry(n)
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
    m, R, C = _geometry(n)
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
    m, R, C = _geometry(n)
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


def _reflection_plan(n: int, indices: Tuple[int, ...]):
    """Plan for one reflection pass on the (R, C) view: the optional
    (C, C) 0/1 lane-sum matrix and the row-axis runs reshape (sum over
    the op's row-qubit bits as a keepdim reduction over contiguous bit
    runs; rank = #runs + 1)."""
    m, _R, C = _geometry(n)
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
    shape = axes = None
    if row_q:
        runs: List[List] = []  # [bit-run length, in-op?]
        for pos in range(n_m):
            member = pos in row_q
            if runs and runs[-1][1] == member:
                runs[-1][0] += 1
            else:
                runs.append([1, member])
        shape = tuple(1 << L for L, _ in runs) + (C,)
        axes = tuple(i for i, (_, mem) in enumerate(runs) if mem)
    return B, shape, axes


def _apply_reflection_2d(n: int, op, x2d: torch.Tensor) -> torch.Tensor:
    """``psi -> 2*mean_Q(psi) - psi`` blockwise on the (R, C) view; the
    operator is real, so each (re, im) plane takes the same transform."""
    B, shape, axes = _reflection_plan(n, tuple(op.indices))
    s = x2d
    if B is not None:
        s = s @ _const(B, x2d)
    scale = 2.0 / (1 << op.num_indices)
    if shape is not None:
        s = torch.sum(s.reshape(shape), dim=axes, keepdim=True)
        return (scale * s - x2d.reshape(shape)).reshape(x2d.shape)
    return scale * s - x2d
