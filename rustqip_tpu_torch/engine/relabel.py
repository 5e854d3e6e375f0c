"""Lazy qubit relabeling: defer SwapOps into an index remap.

The reference executes register swaps as real amplitude moves (its
``MatrixOp::Swap`` iterator, qip-iterators/src/iterators/ops.rs:17); on
TPU a swap is a whole-state HBM pass (structured transpose — see
``engine/apply._apply_swap``). But a swap's only observable effect is a
relabeling of qubit positions, so this pass never moves data mid-circuit:
it tracks the logical->physical position map, rewrites every later gate's
and measurement's indices through it, and materializes the residual
permutation as at most TWO physical SwapOps at the end of the circuit
(any permutation is a product of two involutions; an involution residual
— e.g. a lone QFT bit reversal — stays ONE op, taking the same structured
one-transpose fast path as before).

Net effect: a single trailing swap (phase estimation / Shor readout)
costs exactly what it used to; swap pairs that compensate (QFT around a
diagonal followed by inverse-QFT — Draper-style QFT-basis arithmetic)
cancel to ZERO physical passes; and any interior swap is absorbed into
the indices of the gates behind it.

``RepeatEntry`` bodies are handled body-locally (the body repeats, so its
residual must materialize inside the body); the outer map is materialized
before the block so loop trip semantics never see a pending relabel.

Port of ``rustqip_tpu/engine/relabel.py`` (numpy only). Deferral is always
on here: the JAX package's ``RUSTQIP_TPU_DEFER_SWAPS`` knob is not read.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from rustqip_tpu_torch.ops.matrix_ops import (
    ControlOp,
    DenseOp,
    FnOp,
    MatrixOp,
    PhaseProductOp,
    ReflectionOp,
    SparseOp,
    SwapOp,
)


def remap_op(op: MatrixOp, pos: Sequence[int]) -> MatrixOp:
    """Rewrite ``op`` to act on physical positions ``pos[q]``."""
    if isinstance(op, DenseOp):
        return DenseOp(tuple(pos[q] for q in op.indices), op.data)
    if isinstance(op, SparseOp):
        return SparseOp(tuple(pos[q] for q in op.indices), op.rows)
    if isinstance(op, PhaseProductOp):
        return PhaseProductOp(
            tuple(
                (tuple(pos[q] for q in idx), diag)
                for idx, diag in op.terms
            )
        )
    if isinstance(op, ControlOp):
        return ControlOp(
            op.n_ctrl,
            tuple(pos[q] for q in op.indices),
            remap_op(op.inner, pos),
        )
    if isinstance(op, SwapOp):
        return SwapOp(tuple(pos[q] for q in op.indices))
    if isinstance(op, FnOp):
        # fn is keyed by POSITION within ``indices``: a positional remap
        # is exact.
        return FnOp(
            tuple(pos[q] for q in op.indices), op.fn, op.tag,
            op.conjugated, op.self_transpose, op.diagonal,
        )
    if isinstance(op, ReflectionOp):
        return ReflectionOp(tuple(sorted(pos[q] for q in op.indices)))
    raise TypeError(f"Unknown op {op!r}")


def _two_involutions(target: Sequence[int]) -> List[List[Tuple[int, int]]]:
    """Decompose the position permutation ``target`` (content at position
    x must move to position target[x]) into at most two involutions,
    returned as lists of disjoint transposition pairs (applied in order).

    Construction: per cycle (c_0 -> c_1 -> ... -> c_{L-1} -> c_0) of the
    target, rho1 reflects the cycle about c_0 (c_i <-> c_{-i mod L}) and
    rho2 reflects about the half-step (c_i <-> c_{1-i mod L}); then
    rho2(rho1(c_i)) = c_{i+1} — one step along the cycle. Verified by
    assertion below (a wrong orientation is a silent state corruption
    otherwise)."""
    n = len(target)
    seen = [False] * n
    rho1: dict = {}
    rho2: dict = {}
    for s in range(n):
        if seen[s] or target[s] == s:
            seen[s] = True
            continue
        cyc = [s]
        seen[s] = True
        x = target[s]
        while x != s:
            seen[x] = True
            cyc.append(x)
            x = target[x]
        L = len(cyc)
        for i, c in enumerate(cyc):
            rho1[c] = cyc[(L - i) % L]
            rho2[c] = cyc[(1 - i) % L]
    # verify rho2 o rho1 == target on every moved position
    for x in range(n):
        y = rho1.get(x, x)
        z = rho2.get(y, y)
        assert z == target[x], (x, z, target[x])

    def pairs(rho: dict) -> List[Tuple[int, int]]:
        out = []
        for a, b in rho.items():
            if a < b:
                out.append((a, b))
        return out

    return [p for p in (pairs(rho1), pairs(rho2)) if p]


def materialize(pos: Sequence[int]) -> List[SwapOp]:
    """Physical SwapOps restoring logical layout from ``pos`` (at most 2).

    ``pos[l]`` = physical position currently holding logical qubit l; the
    target permutation moves content at position pos[l] to position l.
    """
    n = len(pos)
    if list(pos) == list(range(n)):
        return []
    target = [0] * n
    for logical, p in enumerate(pos):
        target[p] = logical
    ops = []
    for prs in _two_involutions(target):
        a = [p[0] for p in prs]
        b = [p[1] for p in prs]
        ops.append(SwapOp(tuple(a + b)))
    return ops


def defer_swaps_ops(
    n: int, ops: Sequence[MatrixOp], pos: List[int]
) -> List[MatrixOp]:
    """Rewrite a unitary op run in place of ``pos`` (mutated)."""
    out: List[MatrixOp] = []
    for op in ops:
        if isinstance(op, SwapOp):
            h = op.half
            for a, b in zip(op.indices[:h], op.indices[h:]):
                pos[a], pos[b] = pos[b], pos[a]
            continue
        out.append(remap_op(op, pos))
    return out
