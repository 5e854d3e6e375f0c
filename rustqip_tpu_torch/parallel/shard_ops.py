"""Explicit shard-local / exchange gate application on a sharded state.

Port of ``rustqip_tpu/parallel/shard_ops.py``. The state is a list of D
``(re, im)`` plane pairs in shard order, each the ``(R, C)`` view of a
``2^(n-g)``-amplitude shard (``g = log2 D``) on its shard's device: the top
``g`` qubits are the shard index bits. Ops lower on the host into the JAX
package's schedule entries (``_lower_schedule``, the same kinds and
payloads), then one process runs each entry as a loop over the shards, in
which the shard index ``my`` is a Python int:

* gate on local qubits            -> shard-local sweeps (``run_sweeps``, the
  window kernel on CUDA float32 shards), planned once per schedule in the
  local qubit space;
* diagonal on any qubits          -> zero exchange: each shard's global
  bits are fixed, so the diagonal is a local phase product and a scalar;
* dense gate on one global qubit  -> each shard reads its partner shard
  (``shards[my ^ mask]``, moved with ``.to`` only when its device differs:
  the JAX package's ``ppermute``) and recombines 2x2 blocks on the plain
  path into fresh planes;
* control on global qubits        -> shards whose index bits satisfy the
  controls apply the inner op, the rest are skipped;
* anything else                   -> the relocation schedule, the
  multi-global block exchange, or the generalized-permutation exchange
  (``gex``) of wide function and sparse ops, exactly as lowered by the
  JAX package; a reflection's mean is a (grouped) sum of the shards'
  partial sums (the ``psum``).

``compile_sharded_ops`` plans a lowered schedule once (kernel windows
encoded, exchange blocks and per-shard diagonals prepared);
``ShardSchedule.run`` executes it any number of times (``times``, the
JAX package's ``fori_loop``). No environment variable is read: the
exchange chunk count is an argument (default 1) and the XOR-flip limit of
``gex`` is hard-wired at ``GEX_FLIP_MAX``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from rustqip_tpu_torch.engine.admission import for_device, kernel_policy
from rustqip_tpu_torch.engine.apply import (
    DENSE_CAP,
    _bit_runs,
    _control_mask_2d,
    _inverse_runs,
    _phase_mul_ri,
    _reflection_sum_2d,
    _reindex_op,
    _row_blocks,
)
from rustqip_tpu_torch.engine.real_apply import compile_sweeps, run_sweeps
from rustqip_tpu_torch.errors import CircuitError
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
    fn_values,
    make_swap_op,
    op_to_dense,
)
from rustqip_tpu_torch.types import TORCH_REAL, geometry
from rustqip_tpu_torch.utils.bits import move_bits

Shards = Tuple[List[torch.Tensor], List[torch.Tensor]]

#: Most local op qubits routed through the XOR-flip ``gex`` recombination
#: (the JAX package's ``RUSTQIP_TPU_GEX_FLIP`` default); wider ones gather.
GEX_FLIP_MAX = 4


def _flat_geometry(mesh) -> Tuple[int, int]:
    """``(d, g)`` of a mesh of any shape: the state shards over the
    flattened axis product."""
    d = mesh.size
    g = d.bit_length() - 1
    if d < 1 or (1 << g) != d:
        raise CircuitError("Mesh size must be a power of two")
    return d, g


def _mesh_geometry(mesh) -> Tuple[str, int, int]:
    if len(mesh.axis_names) != 1:
        raise CircuitError(
            "The explicit shard path needs a 1-D mesh; multi-axis "
            "meshes run through compile_sharded"
        )
    d, g = _flat_geometry(mesh)
    return mesh.axis_names[0], d, g


def _op_index_dtype(k: int) -> torch.dtype:
    """Dtype of the op-local ``k``-bit index math of the any-width paths
    (``gex``/``fndiag``): int32 up to 31 qubits, int64 beyond (torch always
    has it, where JAX needs ``jax_enable_x64``); past 63 bits no dtype
    holds the index, and the op raises rather than wrap."""
    if k <= 31:
        return torch.int32
    if k <= 63:
        return torch.int64
    raise CircuitError(
        f"sharded op spans {k} qubits: op-local index math exceeds int64"
    )


def _local_op(op: MatrixOp, g: int) -> MatrixOp:
    """Reindex an op on qubits >= g into the shard-local qubit space."""
    return _reindex_op(op, tuple(q - g for q in op.indices))


def _reflect_psum_groups(g: int, gq: Tuple[int, ...]):
    """Shard groups for a sum over a subset of the g shard-index bits (a
    reflection whose global qubits are a strict subset): shards that agree
    on every non-``gq`` global bit reduce together."""
    keep = 0
    for q in range(g):
        if q not in gq:
            keep |= 1 << (g - 1 - q)
    groups: dict = {}
    for dev in range(1 << g):
        groups.setdefault(dev & keep, []).append(dev)
    return [groups[k] for k in sorted(groups)]


def _remap_op(op: MatrixOp, mapping: dict) -> MatrixOp:
    return _reindex_op(op, tuple(mapping.get(q, q) for q in op.indices))


def _gex_flip_max() -> int:
    """Most local op qubits recombined by XOR-flip re-addressing in
    ``gex`` (hard-wired; the JAX package reads ``RUSTQIP_TPU_GEX_FLIP``)."""
    return GEX_FLIP_MAX


# ---------------------------------------------------------------------------
# Schedule lowering (host side), entry for entry the JAX package's
# ---------------------------------------------------------------------------
#
# Schedule entries:
#   ("local", [ops...])           shard-local engine ops (already reindexed)
#   ("ctrl", gctrl, inner_op)     global controls -> shard-index select
#   ("exchange", d_mask, blocks, rest_local)
#                                 single-global dense: partner + 2x2 blocks
#   ("diag", terms)               zero-exchange diagonal
#   ("fndiag", fnop)              phase oracle: zero-exchange elementwise
#   ("exchange_multi", ...)       dense on h>=2 immovable globals: XOR stages
#   ("reflect", op, gctrl, lctrl) reflection: grouped sum of partial sums
#   ("gex", indices, gq, payload) wide FnOp / sparse tables on immovable
#                                 globals: per-element source routing over
#                                 XOR stages (see _lower_gex)


def _lower_op(n: int, g: int, op: MatrixOp, sched: List) -> None:
    globals_ = tuple(q for q in op.indices if q < g)

    if isinstance(op, SwapOp) and op.half > 1 and globals_:
        # A coalesced multi-pair swap touching global qubits lowers pair by
        # pair (densifying the k-qubit permutation would be 2^k x 2^k).
        for a, b in zip(op.indices[: op.half], op.indices[op.half:]):
            _lower_op(n, g, SwapOp((a, b)), sched)
        return

    if isinstance(op, PhaseProductOp) and globals_:
        terms = []
        for tidx, tdiag in op.terms:
            arr = np.asarray(tdiag, dtype=np.complex128)
            terms.append((tuple(tidx), np.real(arr), np.imag(arr)))
        sched.append(("diag", tuple(terms)))
        return

    if isinstance(op, FnOp) and op.diagonal and globals_:
        # Phase oracle: zero exchange at any width, the global qubits'
        # bits read from the shard index.
        sched.append(("fndiag", op))
        return

    if isinstance(op, ReflectionOp) and globals_:
        # Reflection about the uniform superposition: the distributed mean
        # is one (grouped) sum of the shards' partial sums.
        sched.append(("reflect", op, (), ()))
        return

    if (
        isinstance(op, ControlOp)
        and isinstance(op.inner, ReflectionOp)
        and any(q < g for q in op.inner.indices)
    ):
        gctrl = tuple(q for q in op.control_indices if q < g)
        lctrl = tuple(q - g for q in op.control_indices if q >= g)
        sched.append(("reflect", op.inner, gctrl, lctrl))
        return

    if (
        isinstance(op, ControlOp)
        and isinstance(op.inner, FnOp)
        and op.inner.diagonal
        and globals_
    ):
        # A controlled diagonal is diagonal: fold the control into the fn.
        sched.append(("fndiag", _controlled_fn_op(op)))
        return

    if not globals_:
        lop = _local_op(op, g)
        if sched and sched[-1][0] == "local":
            sched[-1][1].append(lop)
        else:
            sched.append(("local", [lop]))
        return

    if isinstance(op, ControlOp) and all(q >= g for q in op.inner.indices):
        gctrl = tuple(q for q in op.control_indices if q < g)
        lctrl = tuple(q for q in op.control_indices if q >= g)
        inner = op.inner if not lctrl else ControlOp(
            len(lctrl), lctrl + op.inner.indices, op.inner
        )
        sched.append(("ctrl", gctrl, _local_op(inner, g)))
        return

    if isinstance(op, (DenseOp, SwapOp)) and len(globals_) == 1:
        # One global qubit: block-decompose the gate over that qubit's bit
        # and read the partner shard once.
        q = globals_[0]
        mask = 1 << (g - 1 - q)
        mat = op_to_dense(op)
        order = sorted(op.indices, key=lambda x: (x != q, x))
        pos = tuple(order.index(x) for x in op.indices)
        mat_o = expand_op_matrix(mat, pos, len(op.indices))
        half = 1 << (len(op.indices) - 1)
        blocks = (
            (mat_o[:half, :half], mat_o[:half, half:]),
            (mat_o[half:, :half], mat_o[half:, half:]),
        )
        rest_local = tuple(x - g for x in order if x != q)
        sched.append(("exchange", mask, blocks, rest_local))
        return

    # General case: relocate each global target qubit into a free local
    # slot with single-exchange swaps, apply shard-locally, swap back.
    # Global control qubits never move (the index select handles them).
    if isinstance(op, ControlOp):
        move = [q for q in op.target_indices if q < g]
        spare = 0  # the ctrl branch needs all targets local
    else:
        move = list(globals_)
        # Only DenseOp/SwapOp have a single-global exchange branch to
        # absorb one leftover global.
        spare = 1 if isinstance(op, (DenseOp, SwapOp)) else 0
    free_local = [q for q in range(g, n) if q not in op.indices]
    if len(move) - spare > len(free_local):
        if isinstance(op, FnOp):
            # Wide function op with immovable globals: never densify it.
            _lower_gex(op, globals_, sched)
            return
        if isinstance(op, ControlOp) and isinstance(op.inner, FnOp):
            _lower_gex(_controlled_fn_op(op), globals_, sched)
            return
        if isinstance(op, ControlOp) and op.num_indices <= DENSE_CAP:
            # Fold the control into a dense op; its globals then relocate
            # with the one-leftover allowance.
            _lower_op(n, g, DenseOp(op.indices, op_to_dense(op)), sched)
            return
        if not isinstance(op, ControlOp) and op.num_indices <= DENSE_CAP:
            # No room to relocate: direct multi-global block exchange.
            _lower_multi_exchange(n, g, op, globals_, sched)
            return
        if isinstance(op, SparseOp):
            _lower_gex(op, globals_, sched)
            return
        raise CircuitError(
            f"Cannot relocate {len(move)} global qubits: only "
            f"{len(free_local)} free local qubits (n={n})"
        )
    if spare and len(move) > len(free_local):
        # Partial relocation: leave one global in place; the remapped op
        # reaches the single-global exchange branch.
        move = move[1:]
    if not move:  # pragma: no cover - guarded by the branches above
        raise CircuitError(
            f"Cannot lower {type(op).__name__} on globals {globals_} "
            f"(n={n}, mesh={1 << g})"
        )
    # Highest-index free slots: lane qubits of the (R, C) view.
    slots = free_local[-len(move):]
    mapping = {}
    for gq, lq in zip(move, slots):
        mapping[gq] = lq
        mapping[lq] = gq
    swaps = [make_swap_op([gq], [mapping[gq]]) for gq in move]
    for s in swaps:
        _lower_op(n, g, s, sched)
    _lower_op(n, g, _remap_op(op, mapping), sched)
    for s in swaps:
        _lower_op(n, g, s, sched)


def _lower_multi_exchange(
    n: int, g: int, op: MatrixOp, globals_, sched: List
) -> None:
    """Direct block exchange for a dense op on h >= 2 global qubits when no
    free local slot exists: each shard reads its 2^h - 1 partner shards
    and combines them through the op's (2^h x 2^h) grid of sub-blocks, its
    own row selected by the shard index."""
    local_n = n - g
    h = len(globals_)
    k = op.num_indices
    dl = 1 << (k - h)
    order = sorted(globals_) + sorted(q for q in op.indices if q >= g)
    pos = tuple(order.index(x) for x in op.indices)
    mat_o = expand_op_matrix(op_to_dense(op), pos, k)
    bstack = np.empty((1 << h, 1 << h, dl, dl), dtype=np.complex128)
    for gj in range(1 << h):
        for gi in range(1 << h):
            bstack[gj, gi] = mat_o[gj * dl:(gj + 1) * dl, gi * dl:(gi + 1) * dl]
    rest_local = tuple(q - g for q in order[h:])
    gq_sorted = tuple(sorted(globals_))
    sched.append(("exchange_multi", gq_sorted, bstack, rest_local, local_n))


def _controlled_fn_op(op: ControlOp) -> FnOp:
    """An equivalent ``FnOp`` for a ControlOp whose inner is an FnOp: the
    control select moves inside ``fn`` (identity row when any control is
    |0>). Keeps laziness, the ``diagonal`` declaration and the conjugation
    flag (conj(1) == 1 on inactive rows)."""
    inner = op.inner
    nc = op.n_ctrl
    ki = inner.num_indices
    cmask = ((1 << nc) - 1) << ki
    tmask = (1 << ki) - 1

    def fn(row):
        active = (row & cmask) == cmask
        icol, ival = inner.fn(row & tmask)
        ival = torch.as_tensor(ival, device=row.device)
        col = torch.where(active, (row & ~tmask) | icol, row)
        return col, torch.where(active, ival, torch.ones_like(ival))

    return FnOp(
        op.indices,
        fn,
        f"ctrl{nc}:{inner.tag}",
        inner.conjugated,
        inner.self_transpose,
        inner.diagonal,
    )


def _lower_gex(op: MatrixOp, globals_, sched: List) -> None:
    """Generalized-permutation exchange for wide ops with immovable global
    qubits: every element computes its own source from its index (a
    function op's ``fn``, or a sparse op's per-row slot tables), and each
    of the 2^h XOR stages over the op's h global qubits reads the partner
    shard and takes exactly the elements whose source lives there."""
    gq = tuple(sorted(globals_))
    if isinstance(op, FnOp):
        sched.append(("gex", op.indices, gq, ("fn", op)))
        return
    dim = 1 << op.num_indices
    max_nnz = max(len(r) for r in op.rows)
    cols_t = np.zeros((max_nnz, dim), np.int32)
    vre_t = np.zeros((max_nnz, dim), np.float64)
    vim_t = np.zeros((max_nnz, dim), np.float64)
    for row, entries in enumerate(op.rows):
        for t, (c, v) in enumerate(entries):
            cols_t[t, row] = c
            vre_t[t, row] = v.real
            vim_t[t, row] = v.imag
    sched.append(
        ("gex", op.indices, gq, ("sp", max_nnz, cols_t, vre_t, vim_t))
    )


def _lower_schedule(n: int, g: int, ops: Sequence[MatrixOp]) -> List:
    sched: List = []
    for op in ops:
        _lower_op(n, g, op, sched)
    return [
        (e[0], tuple(e[1]), *e[2:]) if e[0] == "local" else e for e in sched
    ]


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------


def _shard_bit(my: int, g: int, q: int) -> int:
    """Global qubit ``q``'s bit in shard index ``my``."""
    return (my >> (g - 1 - q)) & 1


def _full_index(n: int, g: int, my: int, r0: int, r1: int, device):
    """``(rows, cols)`` in the full n-qubit (R, C) view of shard ``my``'s
    local rows ``[r0, r1)``, as int64 tensors that broadcast to the block's
    (rows, C_local) shape."""
    local_n = n - g
    _, R_l, C_l = geometry(local_n)
    m, _, C = geometry(n)
    lr = torch.arange(r0, r1, dtype=torch.int64, device=device)
    lc = torch.arange(C_l, dtype=torch.int64, device=device)
    if C_l == C:
        return (lr + my * R_l)[:, None], lc[None, :]
    flat = (my << local_n) + lr[:, None] * C_l + lc[None, :]
    return flat >> m, flat & (C - 1)


def _op_pattern(n: int, indices, rows, cols, idt):
    """The op-local big-endian index (bit ``k-1-j`` is qubit
    ``indices[j]``) at each full-view (row, col) position."""
    row_runs, col_runs, _, _ = _bit_runs(n, tuple(indices))
    return (move_bits(rows, row_runs) | move_bits(cols, col_runs)).to(idt)


def _xor_read(x2d: torch.Tensor, r0: int, r1: int, lmask: int) -> torch.Tensor:
    """Rows ``[r0, r1)`` of ``x2d`` re-addressed at local flat index
    ``i ^ lmask``: one row select and one lane select, no per-element
    gather (the JAX package's ``_xor_flip_flat``)."""
    C_l = x2d.shape[1]
    cbits = C_l.bit_length() - 1
    rmask, cmask = lmask >> cbits, lmask & (C_l - 1)
    dev = x2d.device
    if rmask:
        rows = torch.arange(r0, r1, device=dev) ^ rmask
        out = x2d.index_select(0, rows)
    else:
        out = x2d[r0:r1]
    if cmask:
        out = out.index_select(1, torch.arange(C_l, device=dev) ^ cmask)
    return out


def _cmul(ar, ai, vr, vi):
    """(ar + i ai)(vr + i vi); ``vi`` None for a real factor."""
    if vi is None:
        return ar * vr, ai * vr
    return ar * vr - ai * vi, ai * vr + ar * vi


class ShardSchedule:
    """A lowered op sequence, planned once for the shards of one mesh.

    ``devices`` are the shard devices in shard order (a device may
    repeat). Shard-local runs and global-control inner ops plan their
    sweeps once in the local qubit space with the admission of the shard
    devices (``kernel_ok``: kernel windows, encoded once and kept on each
    device); the exchange recombinations plan plain sweeps, and with
    ``kernel_ok`` false no window kernel is launched at all. ``chunks``
    splits each single-global exchange along the top local qubits, as
    the JAX package's pipelined exchange (falls back to the whole shard
    when the op's local support touches those qubits)."""

    def __init__(
        self,
        devices: Sequence,
        n: int,
        ops: Sequence[MatrixOp],
        kernel_ok: bool = False,
        chunks: int = 1,
    ):
        self.devices = tuple(torch.device(d) for d in devices)
        d = len(self.devices)
        g = d.bit_length() - 1
        if (1 << g) != d:
            raise CircuitError("Mesh size must be a power of two")
        if n < g:
            raise CircuitError(f"Need at least {g} qubits to shard over {d} devices")
        self.n, self.d, self.g = n, d, g
        self.local_n = n - g
        self.kernel_ok = bool(kernel_ok)
        self.admission = for_device(self.devices[0])
        self.kbits = max(int(chunks).bit_length() - 1, 0)
        self.sched = _lower_schedule(n, g, list(ops))
        self.steps = [self._compile_entry(e) for e in self.sched]

    # -- planning ----------------------------------------------------------
    def _sweeps(self, n: int, ops, kernel: bool):
        return compile_sweeps(n, ops, kernel, self.admission, self.devices[0])

    def _block(self, b: np.ndarray, rest_local, sub_n: int):
        """A recombination block on the plain path: None (zero), a scalar,
        or the plain sweeps of a dense op on ``rest_local``."""
        if not np.any(b):
            return None
        if not rest_local:
            return ("scalar", complex(b[0, 0]))
        lop = DenseOp(tuple(rest_local), np.ascontiguousarray(b))
        return ("sweeps", sub_n, self._sweeps(sub_n, [lop], False))

    def _compile_entry(self, entry):
        kind = entry[0]
        g, local_n = self.g, self.local_n
        if kind == "local":
            return ("local", self._sweeps(local_n, entry[1], self.kernel_ok))
        if kind == "ctrl":
            _, gctrl, inner = entry
            active = [
                my for my in range(self.d)
                if all(_shard_bit(my, g, q) for q in gctrl)
            ]
            return ("ctrl", active, self._sweeps(local_n, [inner], self.kernel_ok))
        if kind == "exchange":
            _, mask, blocks, rest_local = entry
            whole = [[self._block(b, rest_local, local_n) for b in row]
                     for row in blocks]
            chunked = None
            kb = self.kbits
            if kb > 0 and local_n - kb >= 1 and all(q >= kb for q in rest_local):
                sub = tuple(q - kb for q in rest_local)
                chunked = [[self._block(b, sub, local_n - kb) for b in row]
                           for row in blocks]
            return ("exchange", mask, whole, chunked)
        if kind == "exchange_multi":
            _, gq, bstack, rest_local, _ = entry
            h = len(gq)
            per_shard = []
            for my in range(self.d):
                e = 0
                for j, q in enumerate(gq):
                    e |= _shard_bit(my, g, q) << (h - 1 - j)
                stages = []
                for t in range(1 << h):
                    mask_t = 0
                    for j, q in enumerate(gq):
                        if (t >> (h - 1 - j)) & 1:
                            mask_t |= 1 << (g - 1 - q)
                    stages.append(
                        (mask_t, self._block(bstack[e, e ^ t], rest_local, local_n))
                    )
                per_shard.append(stages)
            return ("exchange_multi", per_shard)
        if kind == "diag":
            return ("diag", [self._shard_diag(entry[1], my) for my in range(self.d)])
        if kind == "fndiag":
            return entry
        if kind == "reflect":
            _, rop, gctrl, lctrl = entry
            gq = tuple(q for q in rop.indices if q < g)
            lidx = tuple(q - g for q in rop.indices if q >= g)
            groups = [
                grp for grp in _reflect_psum_groups(g, gq)
                if all(_shard_bit(grp[0], g, q) for q in gctrl)
            ]
            scale = 2.0 / (1 << rop.num_indices)
            return ("reflect", groups, lidx, lctrl, scale)
        if kind == "gex":
            _, indices, gq, payload = entry
            _op_index_dtype(len(indices))
            kl = sum(1 for q in indices if q >= g)
            return ("gex", indices, gq, payload, kl <= _gex_flip_max())
        raise AssertionError(kind)  # pragma: no cover

    def _shard_diag(self, terms, my: int):
        """A diagonal's restriction to shard ``my``: its global qubits'
        bits are fixed, leaving a local phase product and a scalar."""
        g = self.g
        scalar = 1.0 + 0j
        local_terms = []
        for tidx, tre, tim in terms:
            kt = len(tidx)
            d = np.asarray(tre) + 1j * np.asarray(tim)
            base = 0
            lpos = []
            for j, q in enumerate(tidx):
                if q < g:
                    base |= _shard_bit(my, g, q) << (kt - 1 - j)
                else:
                    lpos.append(j)
            if not lpos:
                scalar *= complex(d[base])
                continue
            kl = len(lpos)
            sub = np.arange(1 << kl)
            idx = np.full(1 << kl, base, dtype=np.int64)
            for t, j in enumerate(lpos):
                idx |= ((sub >> (kl - 1 - t)) & 1) << (kt - 1 - j)
            local_terms.append(
                (tuple(tidx[j] - g for j in lpos), tuple(complex(v) for v in d[idx]))
            )
        op = PhaseProductOp(tuple(local_terms)) if local_terms else None
        return op, scalar

    def sweep_counts(self) -> dict:
        """Sweeps one run executes over all shards, by kind: the local and
        global-control sweeps by their plan kind, every other entry as one
        "op" sweep per shard it writes."""
        counts = {"kwindow": 0, "window": 0, "op": 0}
        for step in self.steps:
            if step[0] in ("local", "ctrl"):
                shards = self.d if step[0] == "local" else len(step[1])
                for kind, _p, _r in step[-1]:
                    counts[kind] += shards
            elif step[0] == "reflect":
                counts["op"] += sum(len(grp) for grp in step[1])
            else:
                counts["op"] += self.d
        return counts

    # -- execution ---------------------------------------------------------
    def run(self, re: Sequence[torch.Tensor], im: Sequence[torch.Tensor],
            times: int = 1) -> Shards:
        """Apply the schedule ``times`` times to the shard planes. Kernel
        sweeps update shards in place; other entries write fresh planes."""
        times = int(times)
        if times < 1:
            raise CircuitError("apply_sharded_ops needs times >= 1")
        if len(re) != self.d or len(im) != self.d:
            raise CircuitError(
                f"Expected {self.d} shards, got {len(re)} and {len(im)}"
            )
        _, R_l, C_l = geometry(self.local_n)
        re = [x.reshape(R_l, C_l) for x in re]
        im = [x.reshape(R_l, C_l) for x in im]
        for _ in range(times):
            for step in self.steps:
                re, im = getattr(self, "_run_" + step[0])(step, re, im)
        return re, im

    def _run_local(self, step, re, im):
        sweeps = step[1]
        out = [run_sweeps(self.local_n, sweeps, r, i, low_kernel=self.kernel_ok)
               for r, i in zip(re, im)]
        return [o[0] for o in out], [o[1] for o in out]

    def _run_ctrl(self, step, re, im):
        _, active, sweeps = step
        re, im = list(re), list(im)
        for my in active:
            re[my], im[my] = run_sweeps(
                self.local_n, sweeps, re[my], im[my], low_kernel=self.kernel_ok
            )
        return re, im

    def _apply_block(self, blk, xr, xi):
        if blk[0] == "scalar":
            v = blk[1]
            return xr * v.real - xi * v.imag, xr * v.imag + xi * v.real
        _, sub_n, sweeps = blk
        return run_sweeps(sub_n, sweeps, xr, xi, low_kernel=self.kernel_ok)

    def _combine(self, terms, like):
        """Sum of block applications ``(block, re, im)``; zero blocks
        skipped. Returns fresh planes."""
        acc_r = acc_i = None
        for blk, xr, xi in terms:
            if blk is None:
                continue
            tr, ti = self._apply_block(blk, xr, xi)
            if acc_r is None:
                acc_r, acc_i = tr, ti
            else:
                acc_r, acc_i = acc_r + tr, acc_i + ti
        if acc_r is None:
            return torch.zeros_like(like), torch.zeros_like(like)
        return acc_r, acc_i

    def _run_exchange(self, step, re, im):
        _, mask, whole, chunked = step
        new_r, new_i = [], []
        for my in range(self.d):
            dev = self.devices[my]
            # Own shard has the global bit ``bit``; the partner the other.
            pr, pi = re[my ^ mask].to(dev), im[my ^ mask].to(dev)
            bit = 1 if my & mask else 0
            own_blk, par_blk = (
                (whole[1][1], whole[1][0]) if bit else (whole[0][0], whole[0][1])
            )
            if chunked is None:
                out_r, out_i = self._combine(
                    [(own_blk, re[my], im[my]), (par_blk, pr, pi)], re[my]
                )
            else:
                own_c, par_c = (
                    (chunked[1][1], chunked[1][0]) if bit
                    else (chunked[0][0], chunked[0][1])
                )
                nc = 1 << self.kbits
                _, Rs, Cs = geometry(self.local_n - self.kbits)
                parts_r, parts_i = [], []
                for c, (xr, xi, yr, yi) in enumerate(zip(
                    re[my].reshape(nc, Rs, Cs), im[my].reshape(nc, Rs, Cs),
                    pr.reshape(nc, Rs, Cs), pi.reshape(nc, Rs, Cs),
                )):
                    o_r, o_i = self._combine(
                        [(own_c, xr, xi), (par_c, yr, yi)], xr
                    )
                    parts_r.append(o_r.reshape(-1))
                    parts_i.append(o_i.reshape(-1))
                out_r = torch.cat(parts_r).reshape(re[my].shape)
                out_i = torch.cat(parts_i).reshape(im[my].shape)
            new_r.append(out_r.reshape(re[my].shape))
            new_i.append(out_i.reshape(im[my].shape))
        return new_r, new_i

    def _run_exchange_multi(self, step, re, im):
        per_shard = step[1]
        new_r, new_i = [], []
        for my in range(self.d):
            dev = self.devices[my]
            terms = [
                (blk, re[my ^ mask_t].to(dev), im[my ^ mask_t].to(dev))
                for mask_t, blk in per_shard[my]
            ]
            out_r, out_i = self._combine(terms, re[my])
            new_r.append(out_r.reshape(re[my].shape))
            new_i.append(out_i.reshape(im[my].shape))
        return new_r, new_i

    def _run_diag(self, step, re, im):
        new_r, new_i = [], []
        for my, (op, scalar) in enumerate(step[1]):
            r, i = re[my], im[my]
            if op is not None:
                r, i = _phase_mul_ri(self.local_n, op, r, i)
            if scalar != 1:
                r, i = _cmul(r, i, scalar.real, scalar.imag)
            new_r.append(r)
            new_i.append(i)
        return new_r, new_i

    def _run_fndiag(self, step, re, im):
        fop = step[1]
        idt = _op_index_dtype(fop.num_indices)
        _, R_l, C_l = geometry(self.local_n)
        new_r, new_i = [], []
        for my in range(self.d):
            r, i = re[my], im[my]
            out_r, out_i = torch.empty_like(r), torch.empty_like(i)
            for r0, r1 in _row_blocks(R_l, C_l):
                rows, cols = _full_index(self.n, self.g, my, r0, r1, r.device)
                _, val = fop.fn(_op_pattern(self.n, fop.indices, rows, cols, idt))
                vr, vi = fn_values(val, r, fop.conjugated)
                out_r[r0:r1], out_i[r0:r1] = _cmul(r[r0:r1], i[r0:r1], vr, vi)
            new_r.append(out_r)
            new_i.append(out_i)
        return new_r, new_i

    def _run_reflect(self, step, re, im):
        _, groups, lidx, lctrl, scale = step
        local_n = self.local_n
        _, R_l, C_l = geometry(local_n)
        re, im = list(re), list(im)
        for grp in groups:
            parts = [
                (_reflection_sum_2d(local_n, lidx, re[my]),
                 _reflection_sum_2d(local_n, lidx, im[my]))
                for my in grp
            ]
            totals = {}
            for my in grp:
                dev = self.devices[my]
                if dev not in totals:
                    sr = si = None
                    for (pr, shp), (pi, _) in parts:
                        sr = pr.to(dev) if sr is None else sr + pr.to(dev)
                        si = pi.to(dev) if si is None else si + pi.to(dev)
                    totals[dev] = (sr, si, shp)
                sr, si, shp = totals[dev]
                x_r, x_i = re[my], im[my]
                xs_r = x_r.reshape(shp) if shp is not None else x_r
                xs_i = x_i.reshape(shp) if shp is not None else x_i
                out_r = (scale * sr - xs_r).reshape(R_l, C_l)
                out_i = (scale * si - xs_i).reshape(R_l, C_l)
                if lctrl:
                    mask = _control_mask_2d(local_n, lctrl, R_l, C_l, dev)
                    out_r = torch.where(mask, out_r, x_r)
                    out_i = torch.where(mask, out_i, x_i)
                re[my], im[my] = out_r, out_i
        return re, im

    def _gex_tables(self, payload, device, dtype):
        """The sparse payload's slot tables on ``device``."""
        _, max_nnz, cols_t, vre_t, vim_t = payload
        return [
            (
                torch.as_tensor(cols_t[t], device=device),
                torch.as_tensor(vre_t[t], dtype=dtype, device=device),
                torch.as_tensor(vim_t[t], dtype=dtype, device=device)
                if np.any(vim_t[t]) else None,
            )
            for t in range(max_nnz)
        ]

    def _run_gex(self, step, re, im):
        _, indices, gq, payload, use_flip = step
        n, g, local_n = self.n, self.g, self.local_n
        k, h = len(indices), len(gq)
        idt = _op_index_dtype(k)
        _, R_l, C_l = geometry(local_n)
        _, _, C = geometry(n)
        row_runs, col_runs, row_mask, col_mask = _bit_runs(n, tuple(indices))
        to_row, to_col = _inverse_runs(row_runs), _inverse_runs(col_runs)
        # the XOR-flip deltas: every subset of the op's local bits
        lmasks = [0]
        if use_flip:
            for q in indices:
                if q >= g:
                    bit = 1 << (local_n - 1 - (q - g))
                    lmasks += [m | bit for m in lmasks]
        stage_masks = []
        for t in range(1 << h):
            mask_t = 0
            for jj, q in enumerate(gq):
                if (t >> (h - 1 - jj)) & 1:
                    mask_t |= 1 << (g - 1 - q)
            stage_masks.append(mask_t)
        tables = {}
        new_r, new_i = [], []
        for my in range(self.d):
            dev = self.devices[my]
            r, i = re[my], im[my]
            partners = [
                (my ^ mt, re[my ^ mt].to(dev), im[my ^ mt].to(dev))
                for mt in stage_masks
            ]
            out_r, out_i = torch.empty_like(r), torch.empty_like(i)
            for r0, r1 in _row_blocks(R_l, C_l):
                rows, cols = _full_index(n, g, my, r0, r1, dev)
                pat = _op_pattern(n, indices, rows, cols, idt)
                slots = []  # (op-local source col, value planes) per slot
                if payload[0] == "fn":
                    fop = payload[1]
                    sc, val = fop.fn(pat)
                    vr, vi = fn_values(val, r, fop.conjugated)
                    slots.append((torch.as_tensor(sc, device=dev), vr, vi))
                else:
                    if dev not in tables:
                        tables[dev] = self._gex_tables(payload, dev, r.dtype)
                    for cols_j, vre, vim in tables[dev]:
                        p64 = pat.to(torch.int64)
                        slots.append((cols_j[p64], vre[p64],
                                      None if vim is None else vim[p64]))
                acc_r = torch.zeros(r1 - r0, C_l, dtype=r.dtype, device=dev)
                acc_i = torch.zeros_like(acc_r)
                for sc, vr, vi in slots:
                    sc = sc.to(torch.int64)
                    src = ((rows & ~row_mask) | move_bits(sc, to_row)) * C \
                        + ((cols & ~col_mask) | move_bits(sc, to_col))
                    src_shard = src >> local_n
                    src_local = src & ((1 << local_n) - 1)
                    if use_flip:  # the local index bits the source differs in
                        delta = src_local ^ ((rows * C + cols) & ((1 << local_n) - 1))
                    for p, pr, pi in partners:
                        sel = src_shard == p
                        if use_flip:
                            for lmask in lmasks:
                                s = sel & (delta == lmask)
                                tr, ti = _cmul(
                                    _xor_read(pr, r0, r1, lmask),
                                    _xor_read(pi, r0, r1, lmask),
                                    torch.where(s, vr, 0),
                                    None if vi is None else torch.where(s, vi, 0),
                                )
                                acc_r, acc_i = acc_r + tr, acc_i + ti
                        else:
                            gr = pr.reshape(-1)[src_local]
                            gi = pi.reshape(-1)[src_local]
                            tr, ti = _cmul(gr, gi, vr, vi)
                            acc_r = acc_r + torch.where(sel, tr, 0)
                            acc_i = acc_i + torch.where(sel, ti, 0)
                out_r[r0:r1], out_i[r0:r1] = acc_r, acc_i
            new_r.append(out_r)
            new_i.append(out_i)
        return new_r, new_i


def compile_sharded_ops(
    mesh, n: int, ops: Sequence[MatrixOp], kernel_ok: bool = False,
    chunks: int = 1,
) -> ShardSchedule:
    """Lower and plan ``ops`` once for a 1-D ``mesh`` (see ``ShardSchedule``)."""
    _mesh_geometry(mesh)
    return ShardSchedule(mesh.devices, n, ops, kernel_ok, chunks)


def apply_sharded_ops(
    mesh,
    n: int,
    ops: Sequence[MatrixOp],
    re: Sequence[torch.Tensor],
    im: Sequence[torch.Tensor],
    chunks: int = 1,
    kernel_ok: Optional[bool] = None,
    times: int = 1,
) -> Shards:
    """Apply a gate-op sequence to a sharded state (lists of D planes in
    shard order) with the hand-pinned exchange schedule; ``times`` repeats
    the whole schedule (the JAX package's ``fori_loop``).

    ``kernel_ok`` (None: float32 shards on CUDA) lets shard-local runs and
    the global-control inner applies take the window kernel on each
    shard's own (rows, 128) view; exchange recombinations stay on the
    plain path. ``chunks`` splits each single-global exchange into that
    many pieces along the top local qubits (see ``ShardSchedule``)."""
    kernel_ok = kernel_policy(mesh.devices, re[0].dtype, kernel_ok)
    return compile_sharded_ops(mesh, n, ops, kernel_ok, chunks).run(re, im, times)


def apply_sharded_op(mesh, n: int, op: MatrixOp, re, im) -> Shards:
    """Apply one gate op to a sharded state (see ``apply_sharded_ops``)."""
    return apply_sharded_ops(mesh, n, [op], re, im)


def make_sharded_pair(mesh, n: int, initial_index: int = 0, dtype=np.float32) -> Shards:
    """A basis state as shard planes on the mesh's devices."""
    _, d, g = _mesh_geometry(mesh)
    return _basis_shards(mesh.devices, n, g, initial_index, dtype)


def _basis_shards(devices, n: int, g: int, initial_index: int, dtype) -> Shards:
    initial_index = int(initial_index)
    if not 0 <= initial_index < (1 << n):
        raise CircuitError(
            f"initial_index {initial_index} out of range for {n} qubits"
        )
    local_n = n - g
    _, R_l, C_l = geometry(local_n)
    td = TORCH_REAL[np.dtype(dtype)]
    shard, rest = divmod(initial_index, 1 << local_n)
    row, col = divmod(rest, C_l)
    re, im = [], []
    for my, dev in enumerate(devices):
        r = torch.zeros((R_l, C_l), dtype=td, device=dev)
        if my == shard:
            r[row, col] = 1.0
        re.append(r)
        im.append(torch.zeros_like(r))
    return re, im
