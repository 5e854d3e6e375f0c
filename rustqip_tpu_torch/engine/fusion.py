"""Adjacent-gate fusion (port of ``rustqip_tpu/engine/fusion.py``; numpy only).

The reference offers ``apply_ops`` to sweep several gates in one pass over
the state (``qip-iterators/src/matrix_ops.rs:158-219``, benched against
sequential applies in ``matmul_bench.rs:222-344``). The TPU-native analog is
ahead-of-time fusion: consecutive unitaries whose combined support stays
small are multiplied into one dense gate, so each HBM pass over the 2^n
amplitudes retires as many gates as possible. With ``max_qubits=7`` the fused
matrix is 128x128 — exactly one MXU tile.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from rustqip_tpu_torch.ops.matrix_ops import (
    DenseOp,
    FnOp,
    MatrixOp,
    PhaseProductOp,
    ReflectionOp,
    SwapOp,
    diagonal_of,
    expand_op_matrix,
    op_to_dense,
)

#: Default fusion width. 2^5 = 32-dim fused matrices keep the per-pass matmul
#: cheap while cutting pass count ~3-5x on Clifford+T pipelines.
DEFAULT_MAX_FUSED_QUBITS = 5


def _embed(op: MatrixOp, joint: Tuple[int, ...]) -> np.ndarray:
    """Materialize ``op`` as a dense matrix over the joint qubit set."""
    positions = tuple(joint.index(i) for i in op.indices)
    return expand_op_matrix(op_to_dense(op), positions, len(joint))


def _coalesce_diagonals(
    ops: Sequence[MatrixOp], max_qubits: int
) -> List[MatrixOp]:
    """Merge consecutive diagonal ops into PhaseProductOps.

    Diagonal gates commute among themselves, so any maximal run — whatever
    qubits it touches — is exactly one elementwise pass. Lone small
    diagonals stay as dense ops for the regular fuser to absorb.
    """
    out: List[MatrixOp] = []
    run: List = []

    def flush():
        nonlocal run
        if not run:
            return
        if len(run) == 1 and len(run[0][0]) <= max_qubits:
            idx, d = run[0]
            out.append(DenseOp(tuple(idx), np.diag(np.asarray(d))))
        else:
            out.append(
                PhaseProductOp(
                    tuple(
                        (tuple(idx), tuple(complex(v) for v in d))
                        for idx, d in run
                    )
                )
            )
        run = []

    for op in ops:
        d = diagonal_of(op)
        # Zero diagonal entries (projector-like non-unitary ops, which the
        # reference applies faithfully) cannot enter the log-monomial
        # PhaseProductOp decomposition; they stay as ordinary ops. Non-unit
        # magnitudes are fine (the phase plan carries a log-magnitude part).
        if d is not None and np.all(np.asarray(d[1]) != 0):
            run.append(d)
        else:
            flush()
            out.append(op)
    flush()
    return out


def _coalesce_swaps(ops: Sequence[MatrixOp]) -> List[MatrixOp]:
    """Merge consecutive disjoint SwapOps into one multi-pair SwapOp.

    The engine splits a merged swap into (row <-> col) cross pairs — one
    staged XLA block transpose, ~3 ms at n=28 — plus per-pair dense
    passes for the rest (engine/apply.py:_apply_swap); QFT's reversal
    chain drops from one pass per pair to one transpose + the row-row
    pairs. The sharded lowering re-splits multi-pair swaps touching
    global qubits pair-by-pair (shard_ops._lower_op).
    """
    out: List[MatrixOp] = []
    for op in ops:
        if isinstance(op, SwapOp) and out and isinstance(out[-1], SwapOp):
            prev = out[-1]
            if not set(prev.indices) & set(op.indices):
                h1, h2 = prev.half, op.half
                out[-1] = SwapOp(
                    prev.indices[:h1]
                    + op.indices[:h2]
                    + prev.indices[h1:]
                    + op.indices[h2:]
                )
                continue
        out.append(op)
    return out


def fuse_ops(
    ops: Sequence[MatrixOp],
    max_qubits: int = DEFAULT_MAX_FUSED_QUBITS,
    keep=None,
    joint_ok=None,
) -> List[MatrixOp]:
    """Merge adjacent ops: diagonal runs -> one elementwise pass; swap
    chains -> one permutation gather; everything else greedily into joint
    dense unitaries of <= max_qubits.

    Returns a new op list with identical semantics. Ops too wide to fuse
    pass through untouched (the engine applies any width). ``keep`` is an
    optional predicate: ops it accepts pass through UN-fused — the
    compiler uses it to exempt controlled-butterfly-eligible ops when the
    Pallas kernel path is active (a chain of those retires in one kernel
    sweep; folding them into a joint dense op near the row/col seam would
    produce a gate the window planner cannot kernel at all). Diagonal
    controlled ops are never exempted (the diagonal coalescer handles
    them better).

    ``joint_ok`` is an optional predicate over a joint index tuple: a
    merge that would GROW the running block to a joint it rejects is
    split instead (flush + fresh block). The compiler uses it to keep
    fused joints window-plannable — a joint spanning > 3 row bits can
    only execute as a whole-state dense pass (the pathological
    MXU/gather path, measured ~161 ms/gate at n=28 vs ~7 ms for a
    kernel window sweep), so fusion must not build it from ops the
    window planner could have retired at ~HBM speed. Pure composition
    (an op whose support is already inside the block) always merges —
    it never changes the block's shape."""
    ops = _coalesce_swaps(ops)
    ops = _coalesce_diagonals(ops, max_qubits)
    fused: List[MatrixOp] = []
    block_indices: Tuple[int, ...] = ()
    block_mat: np.ndarray | None = None

    def flush():
        nonlocal block_indices, block_mat
        if block_mat is not None:
            fused.append(DenseOp(block_indices, block_mat))
            block_indices, block_mat = (), None

    for op in ops:
        op_set = set(op.indices)
        joint = block_indices + tuple(i for i in op.indices if i not in block_indices)
        if (
            op.num_indices > max_qubits
            or isinstance(op, FnOp)  # function ops stay lazy — never densify
            # reflections are one reduction pass at any width — never densify
            or isinstance(op, ReflectionOp)
            or (keep is not None and keep(op))
        ):
            flush()
            fused.append(op)
            continue
        if block_mat is None:
            block_indices = tuple(sorted(op_set))
            block_mat = _embed(op, block_indices)
            continue
        if len(joint) <= max_qubits and (
            joint_ok is None
            or op_set <= set(block_indices)  # pure composition: no growth
            or joint_ok(joint)
        ):
            joint = tuple(sorted(joint))
            grown = _embed(DenseOp(block_indices, block_mat), joint)
            block_mat = _embed(op, joint) @ grown
            block_indices = joint
        else:
            flush()
            block_indices = tuple(sorted(op_set))
            block_mat = _embed(op, block_indices)
    flush()
    return fused
