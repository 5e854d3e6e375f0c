"""Real-pair (re, im) gate application: the port's execution domain.

Port of ``rustqip_tpu/engine/real_apply.py``. The host planning (window
collection, step merge, ``plan_sweeps``) is numpy and carries over nearly
line for line; kernel admission reads one ``admission`` object
(``engine/admission.py``) instead of the TPU VMEM models. Execution is
torch on (R, C) planes: "kwindow" sweeps go to the window kernel
(``window_kernel.window_sweep``), "window" sweeps and single-op passes stay
plain torch (the JAX package leaves them to XLA).

``compile_sweeps`` plans an op run once and encodes its kernel windows;
``run_sweeps`` executes such a plan. ``apply_ops_ri`` does both per call.

The state-vector API at the end (``apply_op``, ``apply_op_add``,
``apply_ops``, ``as_vector``, ``as_tensor``) takes flat complex states and
runs them in the port's one execution domain, (re, im) planes of shape
``(R, 128)`` in f32 or f64: one split, the plane engine, one join. The JAX
package's two complex formulations behind the same names, the TPU-tiled
``_apply_to_state`` and the CPU rank-n ``_t_apply``, are backend choices
that the plane engine replaces, and are not carried over.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from rustqip_tpu_torch.engine import copy_probe, monomial, row_swap, window_kernel
from rustqip_tpu_torch.engine.admission import (
    TPU_REFERENCE,
    WINDOW_MAX_OPS,
    for_device,
    kernel_policy,
    thin_segment,
    window_seg_sizes,
)
from rustqip_tpu_torch.engine.apply import (
    DENSE_CAP,
    _apply_reflection_2d,
    _col_swap_planes,
    _const,
    _control_mask_2d,
    _dense_plan,
    _fn_apply_planes,
    _mat_key,
    _phase_mul_ri,
    _phase_plan,
    _sparse_apply_planes,
    _swap_schedule,
)
from rustqip_tpu_torch.ops.matrix_ops import (
    ControlOp,
    DenseOp,
    FnOp,
    MatrixOp,
    PhaseProductOp,
    ReflectionOp,
    SparseOp,
    SwapOp,
    expand_op_matrix,
    op_to_dense,
)
from rustqip_tpu_torch.types import (
    geometry,
    join_planes,
    row_segment_shape,
    split_state,
    state_tensor,
)
from rustqip_tpu_torch.utils.observe import COUNTS, pass_bytes, span, swap_bytes

Pair = Tuple[torch.Tensor, torch.Tensor]

#: Largest strip-window width of the non-kernel ("window") path.
WINDOW_MAX_BITS = 3
#: Kernel-window width ladder (the JAX package's default "4,3,2,1").
WINDOW_MAXH_LADDER = (4, 3, 2, 1)
#: Largest mixed-monomial count for a diagonal absorbed into a window.
WINDOW_DIAG_MIXED_CAP = 96
#: Largest row-bit support of a dense op admitted as an "rmix" step.
RMIX_MAX_ROW_BITS = 2


def _real_block_matmul(xr, xi, B: np.ndarray):
    """x @ B.T on plane pairs, skipping all-zero imaginary parts."""
    bt = np.ascontiguousarray(B.T)
    brj = _const(np.real(bt), xr)
    if not np.any(np.imag(bt)):
        return xr @ brj, xi @ brj
    bij = _const(np.imag(bt), xr)
    return xr @ brj - xi @ bij, xr @ bij + xi @ brj


def _scalar_mul(xr, xi, val: complex):
    if val == 1:
        return xr, xi
    vr, vi = val.real, val.imag
    if vi == 0:
        return xr * vr, xi * vr
    if vr == 0:
        return -xi * vi, xr * vi
    return xr * vr - xi * vi, xr * vi + xi * vr


def _assemble(outs: List[torch.Tensor], two_axes, h: int, R: int, C: int):
    """Reassemble strips by pairwise concatenation along each bit axis."""
    for j in reversed(range(h)):
        ax = two_axes[j]
        outs = [
            torch.cat((outs[2 * t], outs[2 * t + 1]), dim=ax)
            for t in range(len(outs) // 2)
        ]
    return outs[0].reshape(R, C)


def _strips(seg_shape, h: int, C: int, re, im):
    xr = re.reshape(seg_shape + (C,))
    xi = im.reshape(seg_shape + (C,))
    two_axes = tuple(range(1, 2 * h, 2))
    strip_shape = tuple(
        1 if ax in two_axes else d for ax, d in enumerate(seg_shape)
    ) + (C,)

    def strip(i: int):
        idx = [slice(None)] * len(seg_shape) + [slice(None)]
        for pos, ax in enumerate(two_axes):
            idx[ax] = (i >> (h - 1 - pos)) & 1
        return xr[tuple(idx)].reshape(-1, C), xi[tuple(idx)].reshape(-1, C)

    return strip, two_axes, strip_shape


def _dense_ri(n: int, indices, mat: np.ndarray, re, im, low_kernel=True) -> Pair:
    plan = _dense_plan(n, tuple(indices), _mat_key(mat))
    if plan[0] == "low":
        _, B, R, C = plan
        return window_kernel.c64_low_matmul(
            re.reshape(R, C), im.reshape(R, C), B, kernel=low_kernel
        )
    _, blocks, seg_shape, h, R, C = plan
    strip, two_axes, strip_shape = _strips(seg_shape, h, C, re, im)
    cache = {}
    outs_r: List = []
    outs_i: List = []
    for hj in range(1 << h):
        acc_r = acc_i = None
        for hi in range(1 << h):
            blk = blocks.get((hj, hi))
            if blk is None:
                continue
            if hi not in cache:
                cache[hi] = strip(hi)
            sr, si = cache[hi]
            if blk[0] == "scalar":
                tr, ti = _scalar_mul(sr, si, blk[1])
            else:
                tr, ti = _real_block_matmul(sr, si, blk[1])
            if acc_r is None:
                acc_r, acc_i = tr, ti
            else:
                acc_r, acc_i = acc_r + tr, acc_i + ti
        if acc_r is None:
            z = torch.zeros_like(strip(0)[0])
            acc_r, acc_i = z, z
        outs_r.append(acc_r.reshape(strip_shape))
        outs_i.append(acc_i.reshape(strip_shape))
    return (
        _assemble(outs_r, two_axes, h, R, C),
        _assemble(outs_i, two_axes, h, R, C),
    )


def _monomial_ri(n: int, plan, re, im, swap_kernel: bool, inplace: bool) -> Pair:
    """A monomial op's pass (``monomial.monomial_pass``), in the span
    ``rq.op.monomial``: the kernel where ``kernel_policy`` takes the planes
    and the caller keeps the permutation kernels on (``swap_kernel``), the
    plain version otherwise; counted in ``observe.COUNTS["monomial_pass"]``
    and ``["monomial_bytes"]`` (its least bytes) on every device."""
    COUNTS["monomial_pass"] += 1
    COUNTS["monomial_bytes"] += plan.least_bytes(re.element_size())
    with span("rq.op.monomial"):
        kernel = kernel_policy([re.device], re.dtype, None if swap_kernel else False)
        return monomial.monomial_pass(n, plan, re, im, inplace, kernel)


def _control_ri(n: int, op: ControlOp, re, im, low_kernel=True, swap_kernel=True,
                inplace=False) -> Pair:
    plan = monomial.plan_of(n, op)
    if plan is not None:
        return _monomial_ri(n, plan, re, im, swap_kernel, inplace)
    if op.num_indices <= DENSE_CAP:
        return _dense_ri(n, op.indices, op_to_dense(op), re, im, low_kernel)
    _, R, C = geometry(n)
    # The select below reads the input again. Only an inner SwapOp whose row
    # pairs alone run the row-swap kernel (CUDA) updates its planes in place,
    # so only it gets copies; every other inner op returns fresh planes (the
    # cross kernel writes fresh planes for a caller that keeps its input).
    inner_in = (re, im)
    if isinstance(op.inner, SwapOp) and re.is_cuda and swap_kernel:
        cross, rowp, _, _ = _swap_schedule(n, op.inner)
        if rowp and not cross:
            inner_in = copy_probe.plane_copy(re.contiguous(), im.contiguous())
    in_r, in_i = apply_op_ri(n, op.inner, *inner_in, low_kernel=low_kernel,
                             swap_kernel=swap_kernel)
    mask = _control_mask_2d(n, op.control_indices, R, C, re.device)
    return (
        torch.where(mask, in_r.reshape(R, C), re.reshape(R, C)),
        torch.where(mask, in_i.reshape(R, C), im.reshape(R, C)),
    )


_SWAP2 = np.array(
    [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
    dtype=np.complex128,
)


def apply_op_ri(
    n: int, op: MatrixOp, re: torch.Tensor, im: torch.Tensor,
    low_kernel: bool = True, swap_kernel: bool = True, inplace: bool = False,
) -> Pair:
    """Apply one gate op to the (R, C) (re, im) planes of a 2^n state.
    ``low_kernel=False`` keeps a dense op on the lane qubits off the window
    kernel (``c64_low_matmul``'s plain matmuls); ``swap_kernel=False``
    keeps a swap off the row-swap kernels (``row_swap_reference``,
    ``cross_row_swap_reference``) and a controlled swap off ``plane_copy``.
    ``inplace`` says that the caller owns the planes: a swap's cross pairs,
    a reflection and a monomial op then update them in place, in bounded
    scratch; otherwise they write fresh planes (the row-swap kernel of a
    swap without cross pairs updates its planes in place either way).

    A dense op, or a controlled dense or sparse op, whose matrix is
    monomial and not diagonal (``monomial.plan_of``, worked out at compile
    time by ``compile_sweeps``) runs as one monomial pass, which
    ``swap_kernel=False`` keeps off its kernel as it keeps the swaps'.

    A swap with cross pairs on the top row qubits runs in one pass, cross
    and row pairs together (``row_swap.cross_row_swap``); one with row
    pairs alone in ``row_swap.row_swap``; column pairs as one lane relabel;
    row-lane pairs that the cross pass does not take as dense 4 x 4
    passes, counted in ``observe.COUNTS["swap_cross_plain"]`` where they
    run on CUDA with the swap kernels on.

    Each op runs in the span ``rq.op.<kind>`` (``observe.span``; a
    controlled op's inner op in its own, inside ``rq.op.control``; a
    monomial pass in ``rq.op.monomial``, inside ``rq.op.dense`` or
    ``rq.op.control``), and a
    swap adds the bytes its permutation moves to
    ``observe.COUNTS["swap_bytes"]``."""
    _, R, C = geometry(n)
    re, im = re.reshape(R, C), im.reshape(R, C)
    if isinstance(op, PhaseProductOp):
        with span("rq.op.phase"):
            return _phase_mul_ri(n, op, re, im)
    if isinstance(op, DenseOp):
        with span("rq.op.dense"):
            plan = monomial.plan_of(n, op)
            if plan is not None:
                return _monomial_ri(n, plan, re, im, swap_kernel, inplace)
            return _dense_ri(n, op.indices, op.data, re, im, low_kernel)
    if isinstance(op, SparseOp):
        with span("rq.op.sparse"):
            if op.num_indices > DENSE_CAP:
                return _sparse_apply_planes(n, op, re, im)
            return _dense_ri(n, op.indices, op_to_dense(op), re, im, low_kernel)
    if isinstance(op, SwapOp):
        COUNTS["swap_bytes"] += swap_bytes(n, op, re.element_size())
        with span("rq.op.swap"):
            cross, rowp, colp, mixed = _swap_schedule(n, op)
            if cross:
                swap = (row_swap.cross_row_swap if swap_kernel
                        else row_swap.cross_row_swap_reference)
                re, im = swap(n, cross, rowp, re, im, inplace)
            elif rowp:
                swap = row_swap.row_swap if swap_kernel else row_swap.row_swap_reference
                re, im = swap(n, rowp, re, im)
            if colp:
                re, im = _col_swap_planes(n, colp, [re, im])
            if mixed and swap_kernel and re.is_cuda:
                COUNTS["swap_cross_plain"] += 1
            for a, b in mixed:
                re, im = _dense_ri(n, (a, b), _SWAP2, re, im, low_kernel)
            return re, im
    if isinstance(op, ControlOp):
        with span("rq.op.control"):
            return _control_ri(n, op, re, im, low_kernel, swap_kernel, inplace)
    if isinstance(op, FnOp):
        with span("rq.op.fn"):
            return _fn_apply_planes(n, op, re, im)
    if isinstance(op, ReflectionOp):
        with span("rq.op.reflection"):
            return (_apply_reflection_2d(n, op, re, inplace),
                    _apply_reflection_2d(n, op, im, inplace))
    raise TypeError(f"Unknown op {op!r}")


def _plan_of(n: int, op) -> "tuple | None":
    if isinstance(op, DenseOp):
        return _dense_plan(n, tuple(op.indices), _mat_key(op.data))
    if isinstance(op, PhaseProductOp):
        # A diagonal entirely on column qubits is a (C, C) diagonal matrix.
        m, _, _ = geometry(n)
        if op.indices and all(q >= n - m for q in op.indices):
            return _dense_plan(n, tuple(op.indices), _mat_key(op_to_dense(op)))
    return None


def _is_scalar_high(plan) -> bool:
    return (
        plan is not None
        and plan[0] == "blocks"
        and all(b[0] == "scalar" for b in plan[1].values())
    )


def _butterfly_ctrl_spec(n: int, n_m: int, op, rbf_max_bit: int) -> "tuple | None":
    """A ControlOp whose inner is a single-qubit dense gate as a controlled
    butterfly: "cbf" (lane target), "rbf" (low row target) or "cmix" (high
    row target, pairing strips). Returns (kind, bit, inner_1q, ctrl)."""
    if not (
        isinstance(op, ControlOp)
        and isinstance(op.inner, DenseOp)
        and len(op.target_indices) == 1
        and op.inner.num_indices == 1
    ):
        return None
    tq = op.target_indices[0]
    if tq >= n_m:
        kind, bit = "cbf", n - 1 - tq
    elif n_m - 1 - tq <= rbf_max_bit:
        kind, bit = "rbf", n_m - 1 - tq
    else:
        kind, bit = "cmix", tq
    ctrl = tuple(
        ("r", n_m - 1 - q) if q < n_m else ("c", n - 1 - q)
        for q in sorted(op.control_indices)
    )
    return kind, bit, op.inner, ctrl


def butterfly_eligible(n: int, op, admission=TPU_REFERENCE) -> bool:
    """Whether ``op`` will plan as a controlled in-block butterfly (fusion
    exempts such ops when the kernel path is active; ``real_apply``:332)."""
    m, R, _ = geometry(n)
    if R < admission.min_state_rows:
        return False
    n_m = n - m
    spec = _butterfly_ctrl_spec(n, n_m, op, admission.rbf_max_bit)
    if spec is None:
        return False
    if all(q >= n_m for q in op.indices):
        return False
    kind, bit = spec[0], spec[1]
    if kind == "rbf" and (1 << (bit + 1)) > min(admission.max_block_rows, R):
        return False
    return True


def window_joint_ok(n: int, admission=TPU_REFERENCE):
    """The fusion joint predicate of the kernel path: joints capped to
    kernel-window-plannable shapes (``real_apply``:370). None when kernel
    windows cannot form at all."""
    m, R, _ = geometry(n)
    if R < admission.min_state_rows:
        return None
    n_m = n - m
    hcap = max(WINDOW_MAXH_LADDER)
    low_bit = admission.min_joint_row_bit

    def joint_ok(indices):
        row_bits = [n_m - 1 - q for q in indices if q < n_m]
        cap = hcap if len(row_bits) == len(indices) else RMIX_MAX_ROW_BITS
        return len(row_bits) <= cap and (
            not row_bits or min(row_bits) >= low_bit
        )

    return joint_ok


def _abs_coeff_sum(groups) -> float:
    """Sum of the absolute coefficients of one monomial group set."""
    const, row_monos, col_monos, mixed = groups
    return (
        abs(const)
        + sum(abs(c) for _, c in row_monos)
        + sum(abs(c) for _, c in col_monos)
        + sum(abs(c) for _, _, c in mixed)
    )


def _mag_rounded(n: int, op, diag_mag_max: "float | None") -> bool:
    """Whether ``op`` is a PhaseProductOp that a window takes as a diag
    step (``_plan_of`` gives it no matrix) leaving out its log-magnitude
    group, which ``diag_mag_max`` (the admission's) bounds."""
    if not isinstance(op, PhaseProductOp) or _plan_of(n, op) is not None:
        return False
    mag_g = _phase_plan(n, op.terms)[1]
    return (
        mag_g is not None
        and diag_mag_max is not None
        and _abs_coeff_sum(mag_g) <= diag_mag_max
    )


def _window_diag_plan(n: int, op, diag_mag_max: "float | None" = None) -> "tuple | None":
    """A PhaseProductOp as a window's diag step: its angle group, or None.
    A log-magnitude group refuses the step unless ``_mag_rounded``."""
    angle_g, mag_g = _phase_plan(n, op.terms)
    if len(angle_g[3]) > WINDOW_DIAG_MIXED_CAP:
        return None
    if mag_g is not None and not _mag_rounded(n, op, diag_mag_max):
        return None
    return angle_g


def _step_support(n: int, step) -> frozenset:
    """Qubit support of a collected window step (for commute checks)."""
    m, _, _ = geometry(n)
    n_m = n - m
    kind = step[0]
    if kind in ("mix", "rmix"):
        return frozenset(step[1].indices)
    if kind == "low":
        return frozenset(range(n_m, n))
    if kind == "diag":
        const, row_monos, col_monos, mixed = step[1]
        qs = set()
        for rq, _c in row_monos:
            qs.update(rq)
        for cq, _c in col_monos:
            qs.update(cq)
        for rq, cq, _c in mixed:
            qs.update(rq)
            qs.update(cq)
        return frozenset(qs)
    if kind == "cbf":
        qs = {n - 1 - step[1]}
    elif kind == "rbf":
        qs = {n_m - 1 - step[1]}
    else:  # cmix carries the target QUBIT index directly
        qs = {step[1]}
    for ck, pc in step[3] if len(step) > 3 else ():
        qs.add(n_m - 1 - pc if ck == "r" else n - 1 - pc)
    return frozenset(qs)


#: Sentinel: composition applies and yields the identity (drop the step).
_IDENTITY = object()


def _try_compose_steps(n: int, new, old):
    """Compose window step ``new`` into the earlier step ``old``: the
    merged step, ``_IDENTITY``, or None when not composable."""
    k_new, k_old = new[0], old[0]
    if k_new in ("cbf", "rbf", "cmix") and k_new == k_old:
        if new[1] != old[1] or (new[3:] or ()) != (old[3:] or ()):
            return None
        mat = np.array(new[2], dtype=np.complex128).reshape(2, 2) @ np.array(
            old[2], dtype=np.complex128
        ).reshape(2, 2)
        if np.allclose(mat, np.eye(2), atol=1e-12):
            return _IDENTITY
        coeffs = tuple(complex(v) for v in mat.reshape(-1))
        return (k_new, new[1], coeffs) + tuple(new[3:])
    if k_new == "low" and k_old == "low":
        B = np.asarray(new[1]) @ np.asarray(old[1])
        if np.allclose(B, np.eye(B.shape[0]), atol=1e-12):
            return _IDENTITY
        return ("low", B)
    if k_new == "mix" and k_old == "mix":
        op_old, op_new = old[1], new[1]
        joint = tuple(sorted(set(op_old.indices) | set(op_new.indices)))

        def embed(op):
            pos = tuple(joint.index(q) for q in op.indices)
            return expand_op_matrix(op_to_dense(op), pos, len(joint))

        mat = embed(op_new) @ embed(op_old)
        if np.allclose(mat, np.eye(mat.shape[0]), atol=1e-12):
            return _IDENTITY
        op = DenseOp(joint, mat)
        p = _plan_of(n, op)
        if not _is_scalar_high(p):
            return None
        return ("mix", op, p)
    if k_new == "diag" and k_old == "diag":
        c1, rm1, cm1, mx1 = old[1]
        c2, rm2, cm2, mx2 = new[1]

        def combine(a, b, keyfn):
            acc = {}
            for ent in tuple(a) + tuple(b):
                key, c = keyfn(ent)
                acc[key] = acc.get(key, 0.0) + c
            return {k: v for k, v in acc.items() if abs(v) > 1e-14}

        rm = combine(rm1, rm2, lambda e: (e[0], e[1]))
        cm = combine(cm1, cm2, lambda e: (e[0], e[1]))
        mx = combine(mx1, mx2, lambda e: ((e[0], e[1]), e[2]))
        if len(mx) > WINDOW_DIAG_MIXED_CAP:
            return None
        const = float(c1) + float(c2)
        if not rm and not cm and not mx and abs(const) < 1e-14:
            return _IDENTITY
        groups = (
            const,
            tuple(rm.items()),
            tuple(cm.items()),
            tuple((rq, cq, c) for (rq, cq), c in mx.items()),
        )
        return ("diag", groups)
    return None


def merge_window_steps(n: int, steps):
    """Commute-aware peephole over a collected window's steps
    (``real_apply.merge_window_steps``:529)."""
    merged: List = []
    supports: List[frozenset] = []
    for step in steps:
        sup = _step_support(n, step)
        placed = False
        k = len(merged) - 1
        while k >= 0:
            out = _try_compose_steps(n, step, merged[k])
            if out is not None:
                if out is _IDENTITY:
                    del merged[k]
                    del supports[k]
                else:
                    merged[k] = out
                    supports[k] = _step_support(n, out)
                placed = True
                break
            prev = merged[k]
            commutes = not (sup & supports[k]) or (
                step[0] == "diag" and prev[0] == "diag"
            )
            if not commutes:
                break
            k -= 1
        if not placed:
            merged.append(step)
            supports.append(sup)
    return merged


def _collect_window(
    n: int,
    ops,
    start: int,
    max_h: int = WINDOW_MAX_BITS,
    allow_diag: bool = False,
    snapshot=None,
    rbf_max_bit: int = TPU_REFERENCE.rbf_max_bit,
    diag_mag_max: "float | None" = TPU_REFERENCE.diag_mag_max,
):
    """Greedy maximal run of dense ops executable as ONE strip sweep
    (``real_apply._collect_window``:575). Returns
    ``((H_sorted, steps), next_index)`` or ``(None, start)``."""
    m, _, _ = geometry(n)
    n_m = n - m
    H: set = set()
    steps: List = []
    consumed = 0
    pending_B = None
    j = start

    def flush():
        nonlocal pending_B
        if pending_B is not None:
            steps.append(("low", pending_B))
            pending_B = None

    def push_butterfly(kind: str, bit: int, op, ctrl: tuple = ()) -> None:
        mat = np.asarray(op.data, dtype=np.complex128).reshape(2, 2)
        if (
            steps
            and steps[-1][0] == kind
            and steps[-1][1] == bit
            and (steps[-1][3] if len(steps[-1]) > 3 else ()) == ctrl
        ):
            prev = np.array(steps[-1][2], dtype=np.complex128)
            mat = mat @ prev.reshape(2, 2)
            steps.pop()
        coeffs = tuple(complex(v) for v in mat.reshape(-1))
        steps.append((kind, bit, coeffs, ctrl) if ctrl else (kind, bit, coeffs))

    def note() -> None:
        if snapshot is None:
            return
        snap_steps = list(steps)
        if pending_B is not None:
            snap_steps.append(("low", pending_B))
        snapshot(tuple(sorted(H)), snap_steps, j)

    while j < len(ops) and consumed < WINDOW_MAX_OPS:
        op = ops[j]
        if allow_diag and isinstance(op, ControlOp):
            spec = _butterfly_ctrl_spec(n, n_m, op, rbf_max_bit)
            if spec is not None:
                kind, bit, inner1q, ctrl = spec
                if kind == "cmix":
                    new_h = H | {bit}
                    if len(new_h) > max_h:
                        break
                    H = new_h
                flush()
                push_butterfly(kind, bit, inner1q, ctrl)
                j += 1
                consumed += 1
                note()
                continue
        if isinstance(op, (ControlOp, SparseOp)) and op.num_indices <= DENSE_CAP:
            dense = getattr(op, "_window_dense", None)
            if dense is None:
                dense = DenseOp(tuple(op.indices), op_to_dense(op))
                object.__setattr__(op, "_window_dense", dense)
            op = dense
        p = _plan_of(n, op)
        if p is None:
            if allow_diag and isinstance(op, PhaseProductOp):
                dplan = _window_diag_plan(n, op, diag_mag_max)
                if dplan is not None:
                    flush()
                    steps.append(("diag", dplan))
                    j += 1
                    consumed += 1
                    note()
                    continue
            break
        if p[0] == "low":
            if (
                allow_diag
                and isinstance(op, DenseOp)
                and op.num_indices == 1
                and pending_B is None
            ):
                push_butterfly("cbf", n - 1 - op.indices[0], op)
                j += 1
                consumed += 1
                note()
                continue
            B = p[1]
            pending_B = B if pending_B is None else B @ pending_B
            j += 1
            consumed += 1
            note()
            continue
        if (
            allow_diag
            and isinstance(op, DenseOp)
            and op.num_indices == 1
            and op.indices[0] < n_m
            and n_m - 1 - op.indices[0] <= rbf_max_bit
        ):
            flush()
            push_butterfly("rbf", n_m - 1 - op.indices[0], op)
            j += 1
            consumed += 1
            note()
            continue
        if not _is_scalar_high(p):
            rbits = {q for q in op.indices if q < n_m}
            new_h = H | rbits
            if (
                isinstance(op, DenseOp)
                and p[0] == "blocks"
                and len(rbits) <= RMIX_MAX_ROW_BITS
                and len(new_h) <= max_h
            ):
                H = new_h
                flush()
                steps.append(("rmix", op, p))
                j += 1
                consumed += 1
                note()
                continue
            break
        new_h = H | {q for q in op.indices if q < n_m}
        if len(new_h) > max_h:
            break
        H = new_h
        flush()
        steps.append(("mix", op, p))
        j += 1
        consumed += 1
        note()
    flush()
    if consumed == 0:
        return None, start
    return (tuple(sorted(H)), steps), j


def _expand_blocks(n: int, hq, op, plan) -> dict:
    """An op's (j_op, i_op) blocks in window strip index space."""
    m, _, _ = geometry(n)
    blocks = plan[1]
    op_bits = [q for q in sorted(op.indices) if q < n - m]
    h = len(hq)
    h_op = len(op_bits)
    wpos = [hq.index(q) for q in op_bits]
    out = {}
    for jw in range(1 << h):
        j_op = 0
        for t in range(h_op):
            j_op |= ((jw >> (h - 1 - wpos[t])) & 1) << (h_op - 1 - t)
        for i_op in range(1 << h_op):
            blk = blocks.get((j_op, i_op))
            if blk is None:
                continue
            iw = jw
            for t in range(h_op):
                bit = (i_op >> (h_op - 1 - t)) & 1
                pos = h - 1 - wpos[t]
                iw = (iw & ~(1 << pos)) | (bit << pos)
            out[(jw, iw)] = blk
    return out


def _expand_mix(n: int, hq, op, plan) -> dict:
    return {k: blk[1] for k, blk in _expand_blocks(n, hq, op, plan).items()}


def window_ksteps(n: int, hq, steps) -> list:
    """Collection steps -> the kernel's step format (``real_apply``:953)."""
    ksteps = []
    for s in steps:
        if s[0] == "mix":
            ksteps.append(("mix", _expand_mix(n, hq, s[1], s[2])))
        elif s[0] == "rmix":
            ksteps.append(("rmix", _expand_blocks(n, hq, s[1], s[2])))
        elif s[0] == "cmix":
            bp = len(hq) - 1 - hq.index(s[1])
            ksteps.append(("cmix", bp) + tuple(s[2:]))
        else:
            ksteps.append(s)
    return ksteps


def _window_sweep_ri(n: int, window, re, im, low_kernel: bool = True) -> Pair:
    """Execute a collected window as one plain torch sweep (a lone ``low``
    run as ``c64_low_matmul``, whose kernel ``low_kernel`` allows)."""
    hq, steps = window
    h = len(hq)
    m, R, C = geometry(n)
    if h == 0:
        (_, B), = steps
        return window_kernel.c64_low_matmul(
            re.reshape(R, C), im.reshape(R, C), B, kernel=low_kernel
        )
    seg_shape = row_segment_shape(n, m, list(hq))
    strip, two_axes, strip_shape = _strips(seg_shape, h, C, re, im)
    strips = [strip(i) for i in range(1 << h)]
    for step in steps:
        if step[0] == "low":
            strips = [_real_block_matmul(sr, si, step[1]) for sr, si in strips]
            continue
        _, op, plan = step
        wblocks = _expand_blocks(n, hq, op, plan)
        new_strips: List = []
        for jw in range(1 << h):
            acc_r = acc_i = None
            for iw in range(1 << h):
                blk = wblocks.get((jw, iw))
                if blk is None:
                    continue
                sr, si = strips[iw]
                if blk[0] == "scalar":
                    tr, ti = _scalar_mul(sr, si, blk[1])
                else:
                    tr, ti = _real_block_matmul(sr, si, blk[1])
                if acc_r is None:
                    acc_r, acc_i = tr, ti
                else:
                    acc_r, acc_i = acc_r + tr, acc_i + ti
            if acc_r is None:
                z = torch.zeros_like(strips[0][0])
                acc_r, acc_i = z, z
            new_strips.append((acc_r, acc_i))
        strips = new_strips
    return (
        _assemble([s[0].reshape(strip_shape) for s in strips], two_axes, h, R, C),
        _assemble([s[1].reshape(strip_shape) for s in strips], two_axes, h, R, C),
    )


def plan_sweeps(
    n: int, ops: Sequence[MatrixOp], kernel_ok: bool, admission=TPU_REFERENCE
):
    """The sweep decomposition of an op run: ``(kind, payload, run_ops)``
    entries, kind "kwindow" (window kernel), "window" (plain strip sweep)
    or "op" (single-op pass) — ``real_apply.plan_sweeps``:1097 with kernel
    admission read from ``admission``."""
    ops = list(ops)
    plan = []

    def finalize(hq, steps):
        steps = merge_window_steps(n, steps)
        if not steps:
            return None
        return (hq, steps)

    i = 0
    while i < len(ops):
        if kernel_ok:
            placed = False
            cands = {}

            def snap(hq, steps, jj):
                if jj not in cands:
                    cands[jj] = (hq, steps)

            for mh in WINDOW_MAXH_LADDER:
                window, j = _collect_window(
                    n, ops, i, max_h=mh, allow_diag=True, snapshot=snap,
                    rbf_max_bit=admission.rbf_max_bit,
                    diag_mag_max=admission.diag_mag_max,
                )
                if window is None:
                    continue
                window = finalize(*window)
                if window is None:
                    i = j
                    placed = True
                    break
                if admission.applicable(n, window[0], window[1]):
                    plan.append(("kwindow", window, ops[i:j]))
                    i = j
                    placed = True
                    break
            if not placed:
                for jj in sorted(cands, reverse=True):
                    window = finalize(*cands[jj])
                    if window is None:
                        i = jj
                        placed = True
                        break
                    if admission.applicable(n, window[0], window[1]):
                        plan.append(("kwindow", window, ops[i:jj]))
                        i = jj
                        placed = True
                        break
            if placed:
                continue
        window, j = _collect_window(n, ops, i)
        if window is not None:
            window = finalize(*window)
            if window is not None:
                plan.append(("window", window, ops[i:j]))
            i = j
            continue
        plan.append(("op", ops[i], [ops[i]]))
        i += 1
    return plan


def compile_sweeps(
    n: int, ops: Sequence[MatrixOp], kernel_ok: bool, admission=TPU_REFERENCE,
    device=None,
):
    """Plan an op run once and encode each kernel window's step program
    (uploaded to ``device`` when given), and work out each single op's
    monomial plan (``monomial.plan_of``, kept on the op; its kernel tables
    uploaded where the kernels may take it): the per-run work that
    ``run_sweeps`` then repeats is only the sweeps themselves."""
    on_cuda = device is not None and torch.device(device).type == "cuda"
    out = []
    for kind, payload, run in plan_sweeps(n, ops, kernel_ok, admission):
        if kind == "op":
            plan = monomial.plan_of(n, payload)
            if plan is not None and on_cuda:
                plan.tables(device)
        if kind == "kwindow":
            hq, steps = payload
            seg = tuple(window_seg_sizes(n, hq))
            ksteps = window_ksteps(n, hq, steps)
            prog = window_kernel.encode_window(n, seg, ksteps)
            prog.mag_rounded = any(
                _mag_rounded(n, op, admission.diag_mag_max) for op in run
            )
            if on_cuda:
                prog.tensors(device)
            payload = (seg, ksteps, prog)
        out.append((kind, payload, run))
    return out


def run_sweeps(
    n: int, sweeps, re: torch.Tensor, im: torch.Tensor, low_kernel: bool = True,
    swap_kernel: bool = True, inplace: bool = False,
) -> Pair:
    """Execute a ``compile_sweeps`` plan on (R, C) planes. Kernel sweeps
    update their planes in place. ``low_kernel=False`` also keeps
    ``c64_low_matmul`` off the kernel, so a plan without kernel windows
    launches no window kernel at all (the sharded GSPMD counterpart);
    ``swap_kernel=False`` keeps the row-swap, copy and monomial kernels off
    too, so such a plan launches no kernel at all (the plain path);
    ``CompiledCircuit.run`` passes its kernel policy here. ``inplace``
    (the caller owns the planes) goes to ``apply_op_ri``. A kernel window
    runs in the span ``rq.sweep.kernel``, a plain one in
    ``rq.sweep.window``; a plain strip window (h >= 1) is counted in
    ``observe.COUNTS["window_plain"]`` and ``["window_plain_bytes"]``, a
    register-path window on a thin trailing row segment
    (``admission.thin_segment``) in ``["window_stream_thin"]``, a kernel
    window whose diag steps left out a log-magnitude that rounds to 1 in
    float32 (``WindowProgram.mag_rounded``) in ``["diag_mag_rounded"]``."""
    _, R, C = geometry(n)
    re, im = re.reshape(R, C), im.reshape(R, C)
    for kind, payload, _run in sweeps:
        if kind == "kwindow":
            seg, ksteps, prog = payload
            if prog.path == "registers" and thin_segment(seg):
                COUNTS["window_stream_thin"] += 1
            if prog.mag_rounded:
                COUNTS["diag_mag_rounded"] += 1
            with span("rq.sweep.kernel"):
                re, im = window_kernel.window_sweep(
                    n, re.contiguous(), im.contiguous(), seg, ksteps, prog=prog
                )
        elif kind == "window":
            if payload[0]:
                COUNTS["window_plain"] += 1
                COUNTS["window_plain_bytes"] += pass_bytes(n, re.element_size())
            with span("rq.sweep.window"):
                re, im = _window_sweep_ri(n, payload, re, im, low_kernel)
        else:
            re, im = apply_op_ri(n, payload, re, im, low_kernel, swap_kernel, inplace)
    return re, im


def apply_ops_ri(
    n: int,
    ops: Sequence[MatrixOp],
    re: torch.Tensor,
    im: torch.Tensor,
    kernel_ok: "bool | None" = None,
    admission=None,
) -> Pair:
    """Apply ops in sequence with strip-window sweeps (plans per call).

    ``kernel_ok`` goes through ``admission.kernel_policy`` (by default on
    for CUDA planes, always off for float64);
    ``admission`` defaults to the Hopper rules on CUDA and the
    reference's elsewhere. Kernel sweeps update the planes in place, so a
    caller that keeps its input passes a copy."""
    kernel_ok = kernel_policy([re.device], re.dtype, kernel_ok)
    if admission is None:
        admission = for_device(re.device)
    return run_sweeps(n, compile_sweeps(n, ops, kernel_ok, admission), re, im)


# ---------------------------------------------------------------------------
# The state-vector API (L0): flat complex 2^n states in, new states out.
# ---------------------------------------------------------------------------


def as_vector(state) -> torch.Tensor:
    """The flat view of a state (a numpy array becomes a CPU tensor)."""
    return torch.as_tensor(state).reshape(-1)


def as_tensor(state, n: int) -> torch.Tensor:
    """The rank-n ``(2,) * n`` view of a state, qubit q on axis q (a numpy
    array becomes a CPU tensor). Torch holds any rank, but some of its ops
    refuse a tensor of more than 25 axes that they cannot coalesce (n = 28
    is one)."""
    return torch.as_tensor(state).reshape((2,) * n)


def apply_op(n: int, op: MatrixOp, state, device="cuda") -> torch.Tensor:
    """Apply one gate op to a flat 2^n complex state; returns a new flat
    state and leaves ``state`` alone (the reference's
    ``apply_op_overwrite``, qip-iterators/src/matrix_ops.rs:127, with zero
    offsets). A tensor is computed on its own device, a numpy array on
    ``device``. The state is split into (re, im) planes, run through
    ``apply_op_ri`` (the window kernel for a dense op on the lane qubits
    and the row-swap kernel for a swap's row pairs, on a CUDA float32
    state) and joined."""
    return join_planes(*apply_op_ri(n, op, *split_state(n, state, device)))


def apply_op_add(n: int, op: MatrixOp, state, acc, device="cuda") -> torch.Tensor:
    """``acc + op @ state``: the reference's accumulating ``apply_op``
    (qip-iterators/src/matrix_ops.rs:98-123)."""
    out = apply_op(n, op, state, device)
    return state_tensor(acc, out.device).reshape(-1) + out


def apply_ops(n: int, ops: Sequence[MatrixOp], state, device="cuda") -> torch.Tensor:
    """Apply ops in sequence (the reference's ``apply_ops``,
    matrix_ops.rs:158): one split, ``apply_ops_ri`` (strip-window sweeps
    planned per call, the window kernel's on a CUDA float32 state), one
    join. Ops are not fused here: ``fuse_ops`` does that ahead of time."""
    return join_planes(*apply_ops_ri(n, ops, *split_state(n, state, device)))
