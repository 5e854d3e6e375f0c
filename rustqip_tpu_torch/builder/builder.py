"""LocalBuilder: the concrete pipeline-recording circuit builder.

Port of ``rustqip_tpu/builder/builder.py`` (re-design of the reference's
``LocalBuilder``, ``qip/src/builder.rs``): a pure recorder — nothing numeric
happens at build time — whose ``calculate_state*`` lowers the symbolic
pipeline to engine ops, compiles it once (``engine/compile.py``) and runs
it on the builder's ``device``. Randomness comes from an explicit
``torch.Generator`` (or a seed), in place of JAX PRNG keys.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rustqip_tpu_torch.builder.circuit_objects import (
    CircuitObject,
    ControlledMatGate,
    FnGate,
    GlobalPhaseGate,
    MatGate,
    MeasurementObject,
    NamedGate,
    PipelineItem,
    ReflectionGate,
    RepeatBlock,
    RzGate,
    SparseMatGate,
    flatten_pipeline,
    invert_circuit_object,
)
from rustqip_tpu_torch.builder.registers import Register, SplitResult, consume
from rustqip_tpu_torch.builder.traits import (
    AdvancedMixin,
    CircuitBuilderMixin,
    CliffordTMixin,
    GlobalPhaseMixin,
    RotationsMixin,
    TemporaryRegisterMixin,
    UnitaryBuilderMixin,
)
from rustqip_tpu_torch.engine.compile import (
    MeasureEntry,
    PipelineEntry,
    RepeatEntry,
    UnitaryEntry,
    compile_pipeline,
)
from rustqip_tpu_torch.errors import CircuitError
from rustqip_tpu_torch.ops import gates
from rustqip_tpu_torch.ops.matrix_ops import (
    FnOp,
    make_control_op,
    make_matrix_op,
    make_sparse_matrix_op,
    make_swap_op,
)
from rustqip_tpu_torch.types import (
    Angle,
    PiRational,
    canonical_complex_dtype,
)


class MeasurementHandle:
    """Points at a collapsing measurement result (ref builder.rs:594-597)."""

    __slots__ = ("id",)

    def __init__(self, id: int):
        self.id = id


class StochasticMeasurementHandle:
    """Points at a stochastic measurement result (ref builder.rs:614-617)."""

    __slots__ = ("id",)

    def __init__(self, id: int):
        self.id = id


class Measurements:
    """Measurement results of one circuit execution
    (ref ``Measurements``, builder.rs:303-323)."""

    def __init__(self, results: Sequence):
        self._results = list(results)

    def get_measurement(self, handle: MeasurementHandle) -> Tuple[int, float]:
        res = self._results[handle.id]
        if not isinstance(res, tuple):
            raise CircuitError("Handle points at a stochastic measurement")
        outcome, prob = res
        return int(outcome), float(prob)

    def get_stochastic_measurement(
        self, handle: StochasticMeasurementHandle
    ) -> np.ndarray:
        res = self._results[handle.id]
        if isinstance(res, tuple):
            raise CircuitError("Handle points at a collapsing measurement")
        return np.asarray(res)

    def sample_counts(
        self, handle: StochasticMeasurementHandle, shots: int, seed: int = None
    ) -> dict:
        """Draw ``shots`` classical samples from a stochastic measurement's
        outcome distribution; returns {outcome: count}. (Shots are classical
        post-processing — the quantum state was simulated exactly once.)"""
        probs = np.asarray(self.get_stochastic_measurement(handle), dtype=np.float64)
        probs = np.maximum(probs, 0)
        probs = probs / probs.sum()
        rng = np.random.default_rng(seed)
        counts = rng.multinomial(shots, probs)
        return {int(i): int(c) for i, c in enumerate(counts) if c}


def _fn_op(indices: Tuple[int, ...], gate: FnGate) -> FnOp:
    return FnOp(indices, gate.fn, gate.tag, gate.conjugated,
                gate.self_transpose, gate.diagonal)


def _lower_item(item: PipelineItem) -> List[PipelineEntry]:
    """Lower one symbolic pipeline item to engine entries
    (the reference's per-gate lowering, builder.rs:439-511)."""
    indices, co = item
    obj = co.obj
    if isinstance(obj, MeasurementObject):
        return [MeasureEntry(tuple(indices), obj.stochastic)]
    if isinstance(obj, GlobalPhaseGate):
        # Unlike the reference (which drops global phases at execution,
        # builder.rs:432), they execute here as a fused scalar multiply —
        # this keeps conditioned global phases exact. Physically
        # unobservable either way.
        phase = np.exp(1j * (obj.theta.to_float() if isinstance(obj.theta, PiRational) else float(obj.theta)))
        mat = np.array([[phase, 0], [0, phase]], dtype=np.complex128)
        return [UnitaryEntry(make_matrix_op([indices[0]], mat.reshape(-1)))]
    if isinstance(obj, NamedGate):
        if obj.name == "CNOT":
            inner = make_matrix_op(list(indices[1:]), gates.X.reshape(-1))
            return [UnitaryEntry(make_control_op([indices[0]], inner))]
        if obj.name == "SWAP":
            k = len(indices)
            if k % 2 != 0:
                raise CircuitError("SWAP requires an even number of qubits")
            return [
                UnitaryEntry(
                    make_swap_op(list(indices[: k // 2]), list(indices[k // 2 :]))
                )
            ]
        mat = getattr(gates, obj.name)
        return [UnitaryEntry(make_matrix_op(list(indices), mat.reshape(-1)))]
    if isinstance(obj, RzGate):
        return [
            UnitaryEntry(make_matrix_op(list(indices), gates.rz(obj.theta).reshape(-1)))
        ]
    if isinstance(obj, MatGate):
        return [UnitaryEntry(make_matrix_op(list(indices), obj.data.reshape(-1)))]
    if isinstance(obj, SparseMatGate):
        return [UnitaryEntry(make_sparse_matrix_op(list(indices), obj.rows))]
    if isinstance(obj, FnGate):
        return [UnitaryEntry(_fn_op(tuple(indices), obj))]
    if isinstance(obj, ReflectionGate):
        from rustqip_tpu_torch.ops.matrix_ops import make_reflection_op

        return [UnitaryEntry(make_reflection_op(list(indices)))]
    if isinstance(obj, ControlledMatGate):
        if isinstance(obj.mat, ReflectionGate):
            from rustqip_tpu_torch.ops.matrix_ops import make_reflection_op

            return [
                UnitaryEntry(
                    make_control_op(
                        list(indices[: obj.n_ctrl]),
                        make_reflection_op(list(indices[obj.n_ctrl :])),
                    )
                )
            ]
        if isinstance(obj.mat, SparseMatGate):
            inner = make_sparse_matrix_op(
                list(indices[obj.n_ctrl :]), obj.mat.rows
            )
        elif isinstance(obj.mat, FnGate):
            inner = _fn_op(tuple(indices[obj.n_ctrl :]), obj.mat)
        else:
            inner = make_matrix_op(
                list(indices[obj.n_ctrl :]), obj.mat.data.reshape(-1)
            )
        return [UnitaryEntry(make_control_op(list(indices[: obj.n_ctrl]), inner))]
    if isinstance(obj, RepeatBlock):
        body: List[PipelineEntry] = []
        for item in obj.body:
            body.extend(_lower_item(item))
        if any(isinstance(e, MeasureEntry) for e in body):
            raise CircuitError("repeat() bodies must be purely unitary")
        return [RepeatEntry(obj.times, tuple(body))]
    raise CircuitError(f"Cannot lower circuit object {obj!r}")


class LocalBuilder(
    CircuitBuilderMixin,
    UnitaryBuilderMixin,
    CliffordTMixin,
    TemporaryRegisterMixin,
    AdvancedMixin,
    RotationsMixin,
    GlobalPhaseMixin,
):
    """The concrete circuit builder and executor.

    ``dtype`` selects the simulation precision ('f32'/'f64' or a complex
    dtype; default f32) — the stand-in for the reference's
    ``LocalBuilder<f32|f64>`` type parameter (types.rs:6-13). ``device``
    is where the state lives: the CUDA card unless the caller passes
    ``device="cpu"`` (no fallback: without a card the first tensor made
    there raises, as torch does). ``kernel_ok`` selects the
    window kernel for unitary runs: by default on for a CUDA f32 state;
    on a CPU state ``kernel_ok=True`` plans the same kernel windows and
    runs them through the kernel's plain torch version.
    """

    def __init__(
        self,
        dtype=None,
        fuse: bool = True,
        max_fused_qubits: int = None,
        native_conditioning: bool = True,
        device="cuda",
        kernel_ok: Optional[bool] = None,
    ):
        self.pipeline: List[PipelineItem] = []
        self._n = 0
        self._zeroed_qubits: List[Register] = []
        self._measurements = 0
        #: Per-ordinal kind ('collapse' | 'stochastic') — forced-outcome
        #: conditions are only meaningful for collapsing measurements.
        self._measurement_kinds: List[str] = []
        self.dtype = canonical_complex_dtype(dtype)
        self._fuse = fuse
        self._max_fused_qubits = max_fused_qubits
        #: Conditioning strategy. True (default): controlled gates lower to
        #: native engine Control ops — one pipeline entry, no temp qubits,
        #: LINEAR cost under nested conditioning. False: the reference's
        #: per-gate toffoli decompositions (builder.rs:663-815) — faithful
        #: QASM gate streams, but gate count multiplies ~20x per nesting
        #: level (the reference's exp_mod explodes to ~5M gates this way).
        self._native_conditioning = native_conditioning
        self.device = torch.device(device)
        self._kernel_ok = kernel_ok

    # -- CircuitBuilder primitives ------------------------------------------
    @property
    def n(self) -> int:
        return self._n

    def register(self, n: int) -> Register:
        if n <= 0:
            raise CircuitError("Registers must contain at least one qubit")
        r = Register(range(self._n, self._n + n))
        self._n += n
        return r

    def merge_two_registers(self, r1: Register, r2: Register) -> Register:
        i1 = consume(r1, "merge")
        i2 = consume(r2, "merge")
        overlap = set(i1) & set(i2)
        if overlap:
            raise CircuitError(f"Registers share qubits {sorted(overlap)}")
        return Register(i1 + i2)

    def split_register_relative(
        self, r: Register, indices: Iterable[int]
    ) -> SplitResult:
        rn = r.n
        all_indices = consume(r, "split")
        rel = [int(i) for i in indices]
        for i in rel:
            if not 0 <= i < rn:
                raise CircuitError(
                    f"Split index {i} out of range for a {rn}-qubit register"
                )
        if len(set(rel)) != len(rel):
            raise CircuitError("Split indices must be unique")
        selected = tuple(all_indices[i] for i in rel)
        remaining = tuple(a for a in all_indices if a not in selected)
        sel_r = Register(selected) if selected else None
        rem_r = Register(remaining) if remaining else None
        if sel_r is None and rem_r is None:  # pragma: no cover
            raise CircuitError("Split produced no registers")
        return SplitResult(sel_r, rem_r)

    def apply_circuit_object(self, r: Register, co: CircuitObject) -> Register:
        """Record an object; single-qubit objects broadcast over multi-qubit
        registers (ref builder.rs:376-398)."""
        if co.n != 1 and co.n != r.n:
            raise CircuitError("Matrix has incorrect N and cannot be broadcast")
        indices = consume(r, "gate application")
        if co.n == 1 and len(indices) > 1:
            for q in indices:
                self.pipeline.append(((q,), co))
        else:
            self.pipeline.append((indices, co))
        return Register(indices)

    def apply_sparse_matrix(self, r: Register, rows, order=None) -> Register:
        """Apply a sparse unitary given as per-row (col, val) entries — the
        oracle pathway (ref ``UnitaryBuilder`` sparse mat surface,
        qip/src/builder.rs; iterator at qubit_iterators.rs:60). Up to
        ``MAX_SPARSE_BITS`` (20) qubits: ops wider than ``DENSE_CAP`` (10)
        lower to gather passes, narrower ones to dense passes; wider
        oracles take ``apply_fn_matrix`` / ``apply_function_op``.
        ``order`` selects the row/column bit convention (default BigEndian,
        matching the engine)."""
        from rustqip_tpu_torch.types import Representation

        if order is None:
            order = Representation.BigEndian
        # Normalize/validate through the ops constructor, then record.
        op = make_sparse_matrix_op(list(range(r.n)), rows, order)
        return self.apply_circuit_object(
            r, CircuitObject(r.n, SparseMatGate(op.rows))
        )

    def apply_sparse_matrix_from_function(self, r: Register, f, order=None):
        """Record a sparse unitary built from a row -> entries function
        (ref ``make_sparse_matrix_from_function``, matrix_ops.rs:128 — the
        FunctionOpIterator analog, qubit_iterators.rs:223)."""
        from rustqip_tpu_torch.ops.matrix_ops import (
            make_sparse_matrix_from_function,
        )
        from rustqip_tpu_torch.types import Representation

        if order is None:
            order = Representation.BigEndian
        rows = make_sparse_matrix_from_function(r.n, f, order)
        return self.apply_sparse_matrix(r, rows)

    # -- rotations primitive -------------------------------------------------
    def rz(self, r: Register, theta: Angle) -> Register:
        return self.apply_circuit_object(r, CircuitObject(r.n, RzGate(theta)))

    def pipeline_depth(self) -> int:
        return len(self.pipeline)

    def repeat(self, times: int, fn, *regs):
        """Record ``fn(self, *regs)`` once and mark it applied ``times``
        times — planned once and repeated, not unrolled.

        ``fn`` must be purely unitary and must return registers holding the
        same qubits it received (net index permutation identity); Grover
        rounds and Trotter steps fit. TPU-native extension (no reference
        analog — the reference unrolls every repetition on the host).
        """
        if times < 1:
            raise CircuitError("repeat() needs times >= 1")
        in_qubits = sorted(q for r in regs for q in r.indices)
        start = len(self.pipeline)
        out = fn(self, *regs)
        body = tuple(self.pipeline[start:])
        del self.pipeline[start:]
        out_regs = (out,) if isinstance(out, Register) else tuple(out)
        out_qubits = sorted(q for r in out_regs for q in r.indices)
        if in_qubits != out_qubits:
            raise CircuitError(
                "repeat() bodies must return the same qubits they received"
            )
        self.pipeline.append(((), CircuitObject(0, RepeatBlock(times, body))))
        return out

    # -- temp qubits (ref builder.rs:576-589) --------------------------------
    def make_zeroed_temp_qubit(self) -> Register:
        if self._zeroed_qubits:
            return self._zeroed_qubits.pop()
        return self.qubit()

    def return_zeroed_temp_register(self, r: Register) -> None:
        self._zeroed_qubits.extend(self.split_all_register(r))

    # -- measurement (ref builder.rs:599-636) --------------------------------
    def measure(self, r: Register) -> Tuple[Register, MeasurementHandle]:
        indices = consume(r, "measurement")
        self.pipeline.append(
            (indices, CircuitObject(len(indices), MeasurementObject(False)))
        )
        handle = MeasurementHandle(self._measurements)
        self._measurements += 1
        self._measurement_kinds.append("collapse")
        return Register(indices), handle

    def measure_stochastic(
        self, r: Register
    ) -> Tuple[Register, StochasticMeasurementHandle]:
        indices = consume(r, "measurement")
        self.pipeline.append(
            (indices, CircuitObject(len(indices), MeasurementObject(True)))
        )
        handle = StochasticMeasurementHandle(self._measurements)
        self._measurements += 1
        self._measurement_kinds.append("stochastic")
        return Register(indices), handle

    # -- execution ------------------------------------------------------------
    def compile(self):
        """Lower + fuse + plan the current pipeline (cached)."""
        entries: List[PipelineEntry] = []
        for item in self.pipeline:
            entries.extend(_lower_item(item))
        kwargs = {}
        if self._max_fused_qubits is not None:
            kwargs["max_fused_qubits"] = self._max_fused_qubits
        return compile_pipeline(
            self._n, entries, self.dtype, self._fuse, device=self.device,
            kernel_ok=self._kernel_ok, **kwargs,
        )

    def initial_index(
        self, it: Iterable[Tuple[Register, int]] = ()
    ) -> int:
        """Basis-state index from per-register init values: bit j of the
        value goes to the register's j-th qubit (ref builder.rs:409-421)."""
        n = self._n
        idx = 0
        for r, x in it:
            for j, qubit in enumerate(r.indices):
                bit = (int(x) >> j) & 1
                idx |= bit << (n - 1 - qubit)
        return idx

    def calculate_state_with_init(
        self,
        it: Iterable[Tuple[Register, int]] = (),
        generator: Optional[torch.Generator] = None,
        seed: Optional[int] = None,
        conditions: Optional[dict] = None,
    ) -> Tuple[np.ndarray, Measurements]:
        """Execute the circuit from the given classical init
        (ref builder.rs:400-519). Randomness comes from ``generator`` or
        ``seed`` (reproducible), not a global RNG.

        ``conditions`` forces measurement outcomes (the MeasuredCondition
        path, ref measurement_ops.rs:181-218): a dict mapping
        MeasurementHandle (or ordinal int) -> desired outcome, given as an
        int, a ``MeasuredCondition`` (whose optional ``prob`` overrides the
        collapse rescale probability), or an ``(outcome, prob)`` tuple."""
        if self._n == 0:
            raise CircuitError("Circuit has no qubits")
        if generator is None:
            generator = torch.Generator()
            generator.manual_seed(
                seed if seed is not None else int(np.random.randint(0, 2**31 - 1))
            )
        forced = None
        if conditions:
            from rustqip_tpu_torch.ops.measurement_ops import MeasuredCondition

            forced = {}
            for handle, outcome in conditions.items():
                if isinstance(handle, StochasticMeasurementHandle):
                    raise CircuitError(
                        "Cannot force a stochastic measurement (it returns "
                        "the full distribution and never collapses)"
                    )
                ordinal = (
                    handle.id
                    if isinstance(handle, MeasurementHandle)
                    else int(handle)
                )
                if not 0 <= ordinal < len(self._measurement_kinds):
                    raise CircuitError(
                        f"Forced condition ordinal {ordinal} does not refer "
                        f"to a measurement (circuit has "
                        f"{len(self._measurement_kinds)})"
                    )
                if self._measurement_kinds[ordinal] != "collapse":
                    raise CircuitError(
                        f"Forced condition ordinal {ordinal} refers to a "
                        "stochastic measurement; only collapsing "
                        "measurements can be forced"
                    )
                prob = None
                if isinstance(outcome, MeasuredCondition):
                    prob = outcome.prob
                    outcome = outcome.measured
                elif isinstance(outcome, tuple):
                    outcome, prob = outcome
                forced[ordinal] = (
                    int(outcome),
                    None if prob is None else float(prob),
                )
        cc = self.compile()
        state, results = cc.run_complex(
            initial_index=self.initial_index(it), generator=generator,
            forced=forced,
        )
        results_py = [
            (int(res[0]), float(res[1]))
            if isinstance(res, tuple)
            else res.cpu().numpy()
            for res in results
        ]
        return state, Measurements(results_py)

    # -- conditioning (ref Conditionable, builder.rs:663-815) -----------------
    def condition_with(self, cr: Register) -> "Conditioned":
        from rustqip_tpu_torch.builder.conditioning import Conditioned

        return Conditioned(self, cr)

    def try_apply_with_condition(
        self, cr: Register, r: Register, co: CircuitObject
    ) -> Tuple[Register, Register]:
        """Apply ``co`` to ``r`` controlled on all of ``cr``: per-gate
        controlled decompositions into primitive pipeline entries
        (ref builder.rs:663-815). Unlike the reference, MAT is supported
        natively (its todo!() at builder.rs:808) via the engine Control op,
        and Rz/rotations condition correctly."""
        obj = co.obj
        if isinstance(obj, MeasurementObject):
            raise CircuitError("Cannot condition measurements.")
        if self._native_conditioning:
            return self._native_condition(cr, r, co)
        if isinstance(obj, ReflectionGate):
            # The gate core H^k X^k (mcZ) X^k H^k equals -D (it phase-
            # flips |0..0>, i.e. I - 2|0><0|), so conditioning just its
            # central mcZ (C(A B A^dagger) = A C(B) A^dagger) yields
            # C(-D). C(D) needs the extra controlled global phase -1 —
            # realized below as an mcZ on the condition register itself.
            if cr.n == 1:
                cr = self.z(cr)
            else:
                crest, clast = self.split_last_qubit(cr)
                crest, clast = self.try_apply_with_condition(
                    crest, clast, CircuitObject(1, NamedGate("Z"))
                )
                cr = self.merge_two_registers(crest, clast)
            r = self.h(r)
            r = self.not_(r)
            ncr = cr.n
            if r.n == 1:
                cr, r = self.try_apply_with_condition(
                    cr, r, CircuitObject(1, NamedGate("Z"))
                )
            else:
                rest, last = self.split_last_qubit(r)
                big = self.merge_two_registers(cr, rest)
                big, last = self.try_apply_with_condition(
                    big, last, CircuitObject(1, NamedGate("Z"))
                )
                res = self.split_register_relative(big, range(ncr))
                cr = res.selected
                r = self.merge_two_registers(res.remaining, last)
            r = self.not_(r)
            r = self.h(r)
            return cr, r
        if isinstance(obj, NamedGate):
            name = obj.name
            if name == "X":
                return self.toffoli(cr, r)
            if name == "Y":
                # Controlled-Y = S . CX . S^-1 on the target. Note the
                # reference conjugates the other way (s first, builder.rs:
                # 673-677), which yields controlled-(-Y); the order here is
                # exact.
                r = self.s_dagger(r)
                cr, r = self.toffoli(cr, r)
                r = self.s(r)
                return cr, r
            if name == "Z":
                r = self.h(r)
                cr, r = self.toffoli(cr, r)
                r = self.h(r)
                return cr, r
            if name == "H":
                # Controlled-H = Ry(-pi/4) . CX . Ry(pi/4) (ref builder.rs:685)
                r = self.ry_pi_by(r, 4)
                cr, r = self.toffoli(cr, r)
                r = self.ry_pi_by(r, -4)
                return cr, r
            if name == "S":
                return self._conditioned_phase_like(cr, r, lambda b, tq: b.s(tq))
            if name == "T":
                return self._conditioned_phase_like(cr, r, lambda b, tq: b.t(tq))
            if name == "SWAP":
                return self._conditioned_swap(cr, r)
            if name == "CNOT":
                # Merge the CNOT's own control into the condition register
                # (ref builder.rs:754-763).
                if r.n != 2:
                    raise CircuitError("Conditioned CNOT requires 2 qubits")
                rest, first = self.split_first_qubit(r)
                cr = self.merge_two_registers(cr, first)
                cr, rest = self.toffoli(cr, rest)
                cr, first = self.split_last_qubit(cr)
                return cr, self.merge_two_registers(first, rest)
        if isinstance(obj, GlobalPhaseGate):
            # Controlled global phase = phase gate on the controls, via the
            # temp-qubit toffoli trick (ref builder.rs:765-788). Exact here:
            # rz(t) on the raised temp gives e^{+-i t/2}, and the executed
            # global phase e^{i t/2} cancels the uncontrolled branch —
            # diag(1, e^{i t}). (The reference rotates by t/2 and drops the
            # global phase at execution, producing a t/2 relative phase.)
            tq = self.make_zeroed_temp_qubit()
            cr, tq = self.toffoli(cr, tq)
            theta = obj.theta
            half = theta / 2 if isinstance(theta, PiRational) else float(theta) / 2
            tq = self.rz(tq, theta)
            if isinstance(half, PiRational):
                tq = self.apply_global_phase_ratio(tq, half)
            else:
                tq = self.apply_global_phase(tq, half)
            cr, tq = self.toffoli(cr, tq)
            self.return_zeroed_temp_register(tq)
            return cr, r
        if isinstance(obj, RzGate):
            # Exact controlled-Rz: CRz(t) = Rz(t/2) . CX . Rz(-t/2) . CX
            # (per target qubit; toffoli generalizes CX to multi-control).
            # The reference's temp-qubit construction (builder.rs:789-807)
            # leaves a stray e^{-i t/2} on the whole uncontrolled subspace —
            # a control-dependent phase error — so we use this instead.
            theta = obj.theta
            if isinstance(theta, PiRational):
                half, neg_half = theta / 2, -(theta / 2)
            else:
                half, neg_half = float(theta) / 2, -float(theta) / 2
            cr, r = self.toffoli(cr, r)
            r = self.rz(r, neg_half)
            cr, r = self.toffoli(cr, r)
            r = self.rz(r, half)
            return cr, r
        if isinstance(obj, (MatGate, SparseMatGate, FnGate)):
            # Native controlled arbitrary unitary (reference todo!()).
            # FnGate included: a function op has no reference-style gate
            # decomposition without materializing, so both conditioning
            # strategies use the engine Control op for it.
            n_ctrl = cr.n
            merged = self.merge_two_registers(cr, r)
            indices = consume(merged, "controlled gate")
            self.pipeline.append(
                (indices, CircuitObject(len(indices), ControlledMatGate(n_ctrl, obj)))
            )
            new = Register(indices)
            res = self.split_register_relative(new, range(n_ctrl))
            return res.selected, res.remaining
        if isinstance(obj, ControlledMatGate):
            merged = self.merge_two_registers(cr, r)
            indices = consume(merged, "controlled gate")
            n_ctrl = len(indices) - obj.mat.n
            self.pipeline.append(
                (indices, CircuitObject(len(indices), ControlledMatGate(n_ctrl, obj.mat)))
            )
            new = Register(indices)
            res = self.split_register_relative(new, range(len(indices) - co.n))
            return res.selected, res.remaining
        raise CircuitError(f"Cannot condition circuit object {obj!r}")

    def _push_controlled_mat(self, cr: Register, r: Register, mat: MatGate):
        n_ctrl = cr.n
        merged = self.merge_two_registers(cr, r)
        indices = consume(merged, "controlled gate")
        self.pipeline.append(
            (indices, CircuitObject(len(indices), ControlledMatGate(n_ctrl, mat)))
        )
        res = self.split_register_relative(Register(indices), range(n_ctrl))
        return res.selected, res.remaining

    def _native_condition(
        self, cr: Register, r: Register, co: CircuitObject
    ) -> Tuple[Register, Register]:
        """Native conditioning: one engine Control op per gate.

        No temp qubits, no decomposition blowup; nested conditions just
        extend the control list. (The decomposition path remains available
        with native_conditioning=False for reference-faithful QASM.)
        """
        obj = co.obj
        if isinstance(obj, NamedGate):
            name = obj.name
            if name == "SWAP":
                # Per-pair controlled swaps keep matrices 4x4.
                half = r.n // 2
                if r.n % 2 != 0:
                    raise CircuitError("SWAP requires an even number of qubits")
                qs = self.split_all_register(r)
                out_a, out_b = [], []
                for qa, qb in zip(qs[:half], qs[half:]):
                    pair = self.merge_two_registers(qa, qb)
                    cr, pair = self._push_controlled_mat(
                        cr, pair, MatGate(gates.SWAP)
                    )
                    qa, qb = self.split_first_qubit(pair)[::-1]
                    # split_first_qubit -> (rest, first); reorder to (qa, qb)
                    out_a.append(qa)
                    out_b.append(qb)
                return cr, self.merge_registers(out_a + out_b)
            if name == "CNOT":
                # The gate's own control joins the condition register.
                rest, first = self.split_first_qubit(r)
                cr = self.merge_two_registers(cr, first)
                cr, rest = self._push_controlled_mat(cr, rest, MatGate(gates.X))
                cr, first = self.split_last_qubit(cr)
                return cr, self.merge_two_registers(first, rest)
            mat = MatGate(getattr(gates, name))
            if co.n == 1 and r.n > 1:
                qs = self.split_all_register(r)
                outs = []
                for q in qs:
                    cr, q = self._push_controlled_mat(cr, q, mat)
                    outs.append(q)
                return cr, self.merge_registers(outs)
            return self._push_controlled_mat(cr, r, mat)
        if isinstance(obj, RzGate):
            mat = MatGate(gates.rz(obj.theta))
            if r.n > 1:
                qs = self.split_all_register(r)
                outs = []
                for q in qs:
                    cr, q = self._push_controlled_mat(cr, q, mat)
                    outs.append(q)
                return cr, self.merge_registers(outs)
            return self._push_controlled_mat(cr, r, mat)
        if isinstance(obj, GlobalPhaseGate):
            # Conditioned global phase = phase on the controls; realized as
            # a controlled e^{i t} I on one target qubit (exact).
            theta = obj.theta
            phase = np.exp(
                1j * (theta.to_float() if isinstance(theta, PiRational) else float(theta))
            )
            rest, first = self.split_first_qubit(r)
            cr, first = self._push_controlled_mat(
                cr, first, MatGate(phase * np.eye(2))
            )
            out = first if rest is None else self.merge_two_registers(first, rest)
            return cr, out
        if isinstance(obj, (MatGate, SparseMatGate, FnGate, ReflectionGate)):
            return self._push_controlled_mat(cr, r, obj)
        if isinstance(obj, ControlledMatGate):
            n_ctrl_new = cr.n + obj.n_ctrl
            merged = self.merge_two_registers(cr, r)
            indices = consume(merged, "controlled gate")
            self.pipeline.append(
                (
                    indices,
                    CircuitObject(len(indices), ControlledMatGate(n_ctrl_new, obj.mat)),
                )
            )
            n_added = len(indices) - co.n
            res = self.split_register_relative(Register(indices), range(n_added))
            return res.selected, res.remaining
        raise CircuitError(f"Cannot condition circuit object {obj!r}")

    def _conditioned_phase_like(self, cr, r, gate_fn):
        """Controlled-S/T via the temp-qubit toffoli trick
        (ref builder.rs:691-712)."""
        cr = self.merge_two_registers(cr, r)
        tq = self.make_zeroed_temp_qubit()
        cr, tq = self.toffoli(cr, tq)
        tq = gate_fn(self, tq)
        cr, tq = self.toffoli(cr, tq)
        self.return_zeroed_temp_register(tq)
        cr, r = self.split_last_qubit(cr)
        return cr, r

    def _conditioned_swap(self, cr, r):
        """Controlled-SWAP as 3 toffolis per pair (ref builder.rs:713-753)."""
        n = r.n
        if n % 2 != 0:
            raise CircuitError("SWAP requires an even number of qubits")
        rs = self.split_all_register(r)
        ras, rbs = rs[: n // 2], rs[n // 2 :]
        out_a, out_b = [], []
        for qa, qb in zip(ras, rbs):
            ncr = self.merge_two_registers(cr, qa)
            ncr, qb = self.toffoli(ncr, qb)
            cr, qa = self.split_last_qubit(ncr)

            ncr = self.merge_two_registers(cr, qb)
            ncr, qa = self.toffoli(ncr, qa)
            cr, qb = self.split_last_qubit(ncr)

            ncr = self.merge_two_registers(cr, qa)
            ncr, qb = self.toffoli(ncr, qb)
            cr, qa = self.split_last_qubit(ncr)
            out_a.append(qa)
            out_b.append(qb)
        return cr, self.merge_registers(out_a + out_b)

    # -- subcircuits & inversion (ref builder.rs:828-967) ---------------------
    def make_subcircuit(self) -> List[PipelineItem]:
        return list(self.pipeline)

    def apply_subcircuit(self, sc: List[PipelineItem], r: Register) -> Register:
        return apply_pipeline_items(self, sc, r)

    def new_similar(self) -> "LocalBuilder":
        return LocalBuilder(dtype=self.dtype, fuse=self._fuse,
                            max_fused_qubits=self._max_fused_qubits,
                            native_conditioning=self._native_conditioning,
                            device=self.device, kernel_ok=self._kernel_ok)

    @staticmethod
    def invert_subcircuit(sc: List[PipelineItem]) -> List[PipelineItem]:
        """Reverse the pipeline, inverting each object
        (ref builder.rs:851-860)."""
        out: List[PipelineItem] = []
        for indices, co in reversed(sc):
            for inv in invert_circuit_object(co):
                out.append((indices, inv))
        return out

    def apply_inverted_subcircuit(
        self, sc: List[PipelineItem], r: Register
    ) -> Register:
        return self.apply_subcircuit(self.invert_subcircuit(sc), r)

    def apply_conditioned_subcircuit(
        self, sc: List[PipelineItem], cr: Register, r: Register
    ) -> Tuple[Register, Register]:
        """Replay ``sc`` under a condition register (ref builder.rs:863-875)."""
        cb = self.condition_with(cr)
        r = apply_pipeline_items(cb, sc, r)
        cr = cb.dissolve()
        return cr, r

    # -- QASM export -----------------------------------------------------------
    def to_openqasm(self) -> str:
        from rustqip_tpu_torch.qasm.export import to_openqasm

        return to_openqasm(self)

    def write_openqasm_file(self, path) -> None:
        from rustqip_tpu_torch.qasm.export import write_openqasm_file

        write_openqasm_file(self, path)


def apply_pipeline_items(cb, sc: List[PipelineItem], r: Register) -> Register:
    """Replay recorded pipeline items onto ``r``'s qubits, allocating temp
    qubits if the subcircuit is wider than the register
    (ref ``apply_pipeline_objects``, builder.rs:877-921). Item indices are
    positions within the source builder, mapped to r's j-th qubit."""
    rn = r.n
    sc = flatten_pipeline(sc)
    slots: List[Optional[Register]] = [q for q in cb.split_all_register(r)]
    if sc:
        max_index = max(max(indices) for indices, _ in sc if indices)
        if max_index + 1 > rn:
            temp = cb.make_zeroed_temp_register(max_index + 1 - rn)
            slots.extend(cb.split_all_register(temp))
    for indices, co in sc:
        picked = []
        for i in indices:
            if slots[i] is None:  # pragma: no cover
                raise CircuitError("Subcircuit reuses a qubit mid-item")
            picked.append(slots[i])
            slots[i] = None
        sub = cb.merge_registers(picked)
        sub = cb.apply_circuit_object(sub, co)
        for i, q in zip(indices, cb.split_all_register(sub)):
            slots[i] = q
    regs = [q for q in slots if q is not None]
    keep, temps = regs[:rn], regs[rn:]
    tr = cb.merge_registers(temps)
    if tr is not None:
        cb.return_zeroed_temp_register(tr)
    return cb.merge_registers(keep)
