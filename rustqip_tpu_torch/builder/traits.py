"""The builder trait tower as Python mixins (port of
``rustqip_tpu/builder/traits.py``; host-only).

Mirrors the capability-sliced traits of ``qip/src/builder_traits.rs`` so
algorithms are generic over builders: all derived methods here are written
purely against the primitive operations (``register``, ``merge_two_registers``,
``split_register_relative``, ``apply_circuit_object``, ``rz``, temp-qubit
pool) — so they work unchanged on both ``LocalBuilder`` and the
``Conditioned`` wrapper, exactly like the reference's default trait methods.

Tower (reference line refs):
* CircuitBuilderMixin      — builder_traits.rs:61-222 (split/merge algebra)
* UnitaryBuilderMixin      — :242-287 (arbitrary matrices + broadcast)
* CliffordTMixin           — :290-483 (named gates, cnot, swap)
* TemporaryRegisterMixin   — :486-498
* AdvancedMixin            — :501-568 (toffoli decomposition/recursion)
* RotationsMixin           — :572-618 (rx/ry derived from rz)
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import numpy as np

from rustqip_tpu_torch.builder.circuit_objects import CircuitObject, MatGate, NamedGate
from rustqip_tpu_torch.builder.registers import Register, SplitManyResult, SplitResult
from rustqip_tpu_torch.errors import CircuitError
from rustqip_tpu_torch.types import Angle, PiRational


class CircuitBuilderMixin:
    """Register algebra built on the three split/merge primitives."""

    # -- primitives subclasses must provide --------------------------------
    # register(n), merge_two_registers(r1, r2),
    # split_register_relative(r, indices), apply_circuit_object(r, co),
    # calculate_state_with_init(it, ...), n (property)

    def qubit(self) -> Register:
        return self.register(1)

    def qudit(self, n: int) -> Optional[Register]:
        """Register of n qubits; None for n=0 (ref builder_traits.rs:78)."""
        return self.register(n) if n > 0 else None

    def try_register(self, n: int) -> Optional[Register]:
        return self.qudit(n)

    def merge_registers(self, rs: Iterable[Register]) -> Optional[Register]:
        acc: Optional[Register] = None
        for r in rs:
            acc = r if acc is None else self.merge_two_registers(acc, r)
        return acc

    def split_register_absolute(
        self, r: Register, indices: Iterable[int]
    ) -> SplitResult:
        r_indices = list(r.indices)
        rel = [r_indices.index(a) for a in indices if a in r_indices]
        return self.split_register_relative(r, rel)

    def split_all_register(self, r: Register) -> List[Register]:
        """Split into n single-qubit registers (ref :131)."""
        out: List[Register] = []
        while True:
            res = self.split_register_relative(r, [0])
            out.append(res.selected)
            if res.remaining is None:
                return out
            r = res.remaining

    def split_first_qubit(
        self, r: Register
    ) -> Tuple[Optional[Register], Register]:
        res = self.split_register_relative(r, [0])
        return res.remaining, res.selected

    def split_last_qubit(
        self, r: Register
    ) -> Tuple[Register, Optional[Register]]:
        n = r.n
        if n == 1:
            return r, None
        res = self.split_register_relative(r, [n - 1])
        return res.remaining, res.selected

    def split_relative_index_groups(
        self, r: Register, groups: Iterable[Iterable[int]]
    ) -> SplitManyResult:
        """Split into merged groups of relative indices (ref :177-202)."""
        slots: List[Optional[Register]] = [
            q for q in self.split_all_register(r)
        ]
        selected: List[Register] = []
        for group in groups:
            picked = []
            for i in group:
                if slots[i] is None:
                    raise CircuitError(f"Relative index {i} used twice in groups")
                picked.append(slots[i])
                slots[i] = None
            merged = self.merge_registers(picked)
            if merged is not None:
                selected.append(merged)
        remaining = self.merge_registers(q for q in slots if q is not None)
        return SplitManyResult(selected, remaining)

    def calculate_state(self, **kwargs):
        return self.calculate_state_with_init((), **kwargs)


class UnitaryBuilderMixin:
    """Arbitrary-matrix application (ref UnitaryBuilder, :242-287)."""

    @staticmethod
    def matrix_to_circuitobject(n: int, data) -> CircuitObject:
        return CircuitObject(n, MatGate(data))

    # Alias kept for reference-API familiarity.
    vec_matrix_to_circuitobject = matrix_to_circuitobject

    def apply_vec_matrix(self, r: Register, data) -> Register:
        return self.apply_circuit_object(
            r, self.matrix_to_circuitobject(r.n, data)
        )

    def apply_matrix(self, r: Register, data) -> Register:
        return self.apply_vec_matrix(r, data)

    def broadcast_single_qubit_matrix(self, r: Register, data) -> Register:
        """Apply a single-qubit matrix to every qubit of ``r`` (ref :265)."""
        return self.apply_circuit_object(r, self.matrix_to_circuitobject(1, data))

    def apply_fn_matrix(self, r: Register, fn, tag=None,
                        self_transpose: bool = False, diagonal: bool = False):
        """Traced-function unitaries (``FnOp``) are not ported yet."""
        raise NotImplementedError(
            "apply_fn_matrix needs FnOp: ROADMAP port queue item P1"
        )

    def apply_reflection(self, r: Register) -> Register:
        """Reflect ``r`` about its uniform superposition:
        ``psi -> (2|s><s| - I) psi`` with ``|s> = H^n |0>`` — Grover's
        inversion-about-the-mean as ONE native op. The reference (and
        ``algos.grover.diffusion``) composes this from ``2n`` Hadamards,
        ``2n`` X's and a multi-controlled Z — ``O(n)`` state passes; the
        native op is one reduction + one elementwise pass at any width
        (``mean`` then ``2*mean - psi``), and under sharding the
        reduction is a single ``psum`` riding ICI. Conditioning routes
        through ``try_apply_with_condition`` like every gate, so
        ``cb.apply_reflection(r)`` is the controlled reflection."""
        from rustqip_tpu_torch.builder.circuit_objects import ReflectionGate

        return self.apply_circuit_object(
            r, CircuitObject(r.n, ReflectionGate(r.n))
        )


class CliffordTMixin:
    """Named Clifford+T gates (ref CliffordTBuilder, :290-483)."""

    def make_x(self) -> CircuitObject:
        return CircuitObject(1, NamedGate("X"))

    def make_y(self) -> CircuitObject:
        return CircuitObject(1, NamedGate("Y"))

    def make_z(self) -> CircuitObject:
        return CircuitObject(1, NamedGate("Z"))

    def make_h(self) -> CircuitObject:
        return CircuitObject(1, NamedGate("H"))

    def make_s(self) -> CircuitObject:
        return CircuitObject(1, NamedGate("S"))

    def make_t(self) -> CircuitObject:
        return CircuitObject(1, NamedGate("T"))

    def make_cnot(self) -> CircuitObject:
        return CircuitObject(2, NamedGate("CNOT"))

    def not_(self, r: Register) -> Register:
        return self.x(r)

    def x(self, r: Register) -> Register:
        return self.apply_circuit_object(r, self.make_x())

    def y(self, r: Register) -> Register:
        return self.apply_circuit_object(r, self.make_y())

    def z(self, r: Register) -> Register:
        return self.apply_circuit_object(r, self.make_z())

    def h(self, r: Register) -> Register:
        return self.apply_circuit_object(r, self.make_h())

    def s(self, r: Register) -> Register:
        return self.apply_circuit_object(r, self.make_s())

    def t(self, r: Register) -> Register:
        return self.apply_circuit_object(r, self.make_t())

    def s_dagger(self, r: Register) -> Register:
        # S^-1 = S.Z (ref :419-422)
        return self.s(self.z(r))

    def t_dagger(self, r: Register) -> Register:
        # T^-1 = T.S^-1 (ref :408-411)
        return self.t(self.s_dagger(r))

    def cnot(self, cr: Register, r: Register) -> Tuple[Register, Register]:
        """CNOT with single control, broadcast over target qubits
        (ref :425-451)."""
        if cr.n > 1:
            raise CircuitError("Clifford CNOT can only have a single control qubit.")
        targets = self.split_all_register(r)
        out = []
        for q in targets:
            merged = self.merge_two_registers(cr, q)
            merged = self.apply_circuit_object(merged, self.make_cnot())
            res = self.split_register_relative(merged, [0])
            cr, q = res.selected, res.remaining
            out.append(q)
        return cr, self.merge_registers(out)

    def swap(self, ra: Register, rb: Register) -> Tuple[Register, Register]:
        """SWAP as 3 CNOTs per qubit pair (ref :454-482)."""
        if ra.n != rb.n:
            raise CircuitError("Swap must be between registers of the same size.")
        ras = self.split_all_register(ra)
        rbs = self.split_all_register(rb)
        new_a, new_b = [], []
        for qa, qb in zip(ras, rbs):
            qa, qb = self.cnot(qa, qb)
            qb, qa = self.cnot(qb, qa)
            qa, qb = self.cnot(qa, qb)
            new_a.append(qa)
            new_b.append(qb)
        return self.merge_registers(new_a), self.merge_registers(new_b)

    def swap_registers(
        self, ra: Register, rb: Register
    ) -> Tuple[Register, Register]:
        """Native register swap: records ONE symbolic SWAP object, which
        the engine executes as a single bit-permutation gather pass (and
        coalesces with adjacent swaps) — vs ``swap``'s reference-parity 3
        CNOTs per pair. Conditions correctly (the SWAP object lowers to
        native controlled swaps under a Conditioned builder)."""
        if ra.n != rb.n:
            raise CircuitError("Swap must be between registers of the same size.")
        k = ra.n
        merged = self.merge_two_registers(ra, rb)
        merged = self.apply_circuit_object(
            merged, CircuitObject(2 * k, NamedGate("SWAP"))
        )
        res = self.split_register_relative(merged, range(k))
        return res.selected, res.remaining


class TemporaryRegisterMixin:
    """Zeroed temp-qubit pool (ref TemporaryRegisterBuilder, :486-498)."""

    def make_zeroed_temp_register(self, n: int) -> Register:
        qs = [self.make_zeroed_temp_qubit() for _ in range(n)]
        return self.merge_registers(qs)


class AdvancedMixin:
    """Toffoli construction (ref AdvancedCircuitBuilder, :501-568)."""

    def basic_toffoli(self, cr: Register, r: Register) -> Tuple[Register, Register]:
        """Standard 2-control Toffoli via H/T/CNOT (ref :505-538).

        Multi-qubit targets run the full decomposition per target qubit —
        the control-side T-phase corrections cannot be shared across
        targets without introducing control-dependent phases.
        """
        if cr.n != 2:
            raise CircuitError(
                "Basic Toffoli can only be applied to two control qubits."
            )
        if r.n > 1:
            targets = self.split_all_register(r)
            out = []
            for q in targets:
                cr, q = self.basic_toffoli(cr, q)
                out.append(q)
            return cr, self.merge_registers(out)
        res = self.split_register_relative(cr, [0])
        cra, crb = res.selected, res.remaining
        r = self.h(r)
        crb, r = self.cnot(crb, r)
        r = self.t_dagger(r)
        cra, r = self.cnot(cra, r)
        r = self.t(r)
        crb, r = self.cnot(crb, r)
        r = self.t_dagger(r)
        cra, r = self.cnot(cra, r)
        crb = self.t(crb)
        r = self.t(r)
        cra, crb = self.cnot(cra, crb)
        r = self.h(r)
        cra = self.t(cra)
        crb = self.t_dagger(crb)
        cra, crb = self.cnot(cra, crb)
        return self.merge_two_registers(cra, crb), r

    def toffoli(self, cr: Register, r: Register) -> Tuple[Register, Register]:
        """n-control Toffoli by recursion with pooled temp qubits
        (ref :541-568)."""
        if cr.n == 1:
            return self.cnot(cr, r)
        if cr.n == 2:
            return self.basic_toffoli(cr, r)
        res = self.split_register_relative(cr, [0, 1])
        crhead, crtail = res.selected, res.remaining
        tr = self.make_zeroed_temp_qubit()
        crhead, tr = self.toffoli(crhead, tr)
        cr2 = self.merge_two_registers(crtail, tr)
        cr2, r = self.toffoli(cr2, r)
        crtail, tr = self.split_last_qubit(cr2)
        crhead, tr = self.toffoli(crhead, tr)
        self.return_zeroed_temp_register(tr)
        return self.merge_two_registers(crhead, crtail), r


class GlobalPhaseMixin:
    """Global-phase application (ref builder.rs:32-56). Routed through
    ``apply_circuit_object`` so it conditions correctly on wrappers."""

    def apply_global_phase(self, r: Register, theta: float) -> Register:
        from rustqip_tpu_torch.builder.circuit_objects import GlobalPhaseGate

        return self.apply_circuit_object(
            r, CircuitObject(r.n, GlobalPhaseGate(float(theta)))
        )

    def apply_global_phase_ratio(self, r: Register, theta: PiRational) -> Register:
        from rustqip_tpu_torch.builder.circuit_objects import GlobalPhaseGate

        return self.apply_circuit_object(
            r, CircuitObject(r.n, GlobalPhaseGate(theta))
        )

    def apply_global_phase_pi_by(self, r: Register, m: int) -> Register:
        return self.apply_global_phase_ratio(r, PiRational(1, m))


class RotationsMixin:
    """Axis rotations derived from the rz primitive (ref RotationsBuilder,
    :572-618).

    Conventions: rz(t)=diag(e^{-it/2}, e^{it/2}); rx(t)=H rz(t) H;
    ry(t)=S^† H rz(-t) H S = exp(-i t Y/2). Note the reference's float-path
    ``ry`` (builder_traits.rs:582-588) conjugates in the opposite order from
    its own ``ry_ratio`` (:600-606), yielding Ry(-t); we use the ry_ratio
    order for both so ry(t) == exp(-i t Y / 2) consistently (the order the
    reference's own conditioned-H decomposition relies on, builder.rs:685).
    """

    def _ry_circuit(self, r: Register, theta: Angle) -> Register:
        r = self.s(r)
        r = self.h(r)
        r = self.rz(r, -theta if isinstance(theta, PiRational) else -float(theta))
        r = self.h(r)
        return self.s_dagger(r)

    def rx(self, r: Register, theta: float) -> Register:
        r = self.h(r)
        r = self.rz(r, theta)
        return self.h(r)

    def ry(self, r: Register, theta: float) -> Register:
        return self._ry_circuit(r, float(theta))

    def rz_ratio(self, r: Register, theta: PiRational) -> Register:
        return self.rz(r, theta)

    def rx_ratio(self, r: Register, theta: PiRational) -> Register:
        r = self.h(r)
        r = self.rz_ratio(r, theta)
        return self.h(r)

    def ry_ratio(self, r: Register, theta: PiRational) -> Register:
        return self._ry_circuit(r, theta)

    def rz_pi_by(self, r: Register, m: int) -> Register:
        if m == 0:
            raise CircuitError("Cannot rotate by pi/0")
        return self.rz_ratio(r, PiRational(1, m))

    def rx_pi_by(self, r: Register, m: int) -> Register:
        if m == 0:
            raise CircuitError("Cannot rotate by pi/0")
        return self.rx_ratio(r, PiRational(1, m))

    def ry_pi_by(self, r: Register, m: int) -> Register:
        if m == 0:
            raise CircuitError("Cannot rotate by pi/0")
        return self.ry_ratio(r, PiRational(1, m))


def make_circuit_matrix(cb, r: Register, dtype=np.complex128) -> np.ndarray:
    """The circuit's unitary expressed in register ``r``'s big-endian basis
    (r's qubit 0 = most significant bit of row/column index).

    Debug/verification helper (ref ``make_circuit_matrix``,
    builder_traits.rs:656-665, which leaves rows in raw state order — here
    rows are permuted into the register basis so the result is basis-
    consistent for any qubit ordering). Qubits outside ``r`` (e.g. temp
    qubits) are initialized to and projected at |0>; if the circuit leaks
    amplitude onto them the columns won't be unit-norm.
    """
    from rustqip_tpu_torch.utils import flip_bits

    k = r.n
    n = cb.n
    dim = 1 << k
    # State index for register-basis row m (other qubits at 0).
    row_map = np.zeros(dim, dtype=np.int64)
    for m in range(dim):
        s = 0
        for j, q in enumerate(r.indices):
            if (m >> (k - 1 - j)) & 1:
                s |= 1 << (n - 1 - q)
        row_map[m] = s
    cols = []
    for indx in range(dim):
        # Init values are little-endian across register qubits
        # (bit j -> r's j-th qubit); bit-reverse so column `indx` is the
        # big-endian register basis state.
        state, _ = cb.calculate_state_with_init([(r, flip_bits(k, indx))])
        cols.append(np.asarray(state)[row_map])
    return np.stack(cols, axis=1).astype(dtype)
