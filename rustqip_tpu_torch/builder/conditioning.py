"""The ``Conditioned`` wrapper builder.

Mirrors ``qip/src/conditioning.rs``: ``b.condition_with(cr)`` returns a
builder that routes every applied circuit object through the parent's
``try_apply_with_condition``, so generic algorithms run unchanged under a
control register; ``dissolve()`` returns the control. Nested conditioning
merges control registers (conditioning.rs:187-207).

Because the whole trait tower here is mixins written against
``apply_circuit_object`` (see ``traits.py``), every derived gate — including
the rotations — conditions correctly. (The reference delegates its
RotationsBuilder methods to the *parent* builder, conditioning.rs:130-168,
which silently drops the control on ``cb.rz*``; that is fixed here, and is
what makes the generic QFT's controlled-phase ladder actually controlled.)
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from rustqip_tpu_torch.builder.circuit_objects import CircuitObject, PipelineItem
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
from rustqip_tpu_torch.errors import CircuitError
from rustqip_tpu_torch.types import Angle


class Conditioned(
    CircuitBuilderMixin,
    UnitaryBuilderMixin,
    CliffordTMixin,
    TemporaryRegisterMixin,
    AdvancedMixin,
    RotationsMixin,
    GlobalPhaseMixin,
):
    """A builder whose every unitary is controlled on ``cr``."""

    def __init__(self, parent, cr: Register):
        consume(cr, "condition_with")
        self.parent = parent
        self._cr: Optional[Register] = Register(cr.indices)

    def dissolve(self) -> Register:
        """Tear down the wrapper and recover the control register
        (ref conditioning.rs:43-46)."""
        cr = self._cr
        self._cr = None
        return cr

    def _take_cr(self) -> Register:
        if self._cr is None:
            raise CircuitError("Conditioned builder was already dissolved")
        cr = self._cr
        self._cr = None
        return cr

    # -- delegated primitives (ref conditioning.rs:48-94) -------------------
    @property
    def n(self) -> int:
        return self.parent.n

    def register(self, n: int) -> Register:
        return self.parent.register(n)

    def merge_two_registers(self, r1: Register, r2: Register) -> Register:
        return self.parent.merge_two_registers(r1, r2)

    def split_register_relative(
        self, r: Register, indices: Iterable[int]
    ) -> SplitResult:
        return self.parent.split_register_relative(r, indices)

    def calculate_state_with_init(self, it=(), **kwargs):
        return self.parent.calculate_state_with_init(it, **kwargs)

    def make_zeroed_temp_qubit(self) -> Register:
        # Temp qubits are NOT conditioned (ref conditioning.rs:170-180).
        return self.parent.make_zeroed_temp_qubit()

    def return_zeroed_temp_register(self, r: Register) -> None:
        self.parent.return_zeroed_temp_register(r)

    # -- the conditioning hook (ref conditioning.rs:76-85) -------------------
    def apply_circuit_object(self, r: Register, co: CircuitObject) -> Register:
        if co.n == 1 and r.n > 1:
            # Broadcast before conditioning so per-gate decompositions always
            # see single-qubit targets.
            qs = self.split_all_register(r)
            out = []
            for q in qs:
                out.append(self.apply_circuit_object(q, co))
            return self.merge_registers(out)
        cr = self._take_cr()
        cr, r = self.parent.try_apply_with_condition(cr, r, co)
        self._cr = cr
        return r

    # -- rotations route through apply_circuit_object ------------------------
    def rz(self, r: Register, theta: Angle) -> Register:
        from rustqip_tpu_torch.builder.circuit_objects import RzGate

        return self.apply_circuit_object(r, CircuitObject(r.n, RzGate(theta)))

    # -- nested conditioning (ref conditioning.rs:187-207) -------------------
    def try_apply_with_condition(
        self, cr: Register, r: Register, co: CircuitObject
    ) -> Tuple[Register, Register]:
        ncr = cr.n
        ccr = self._take_cr()
        merged = self.merge_two_registers(cr, ccr)
        merged, r = self.parent.try_apply_with_condition(merged, r, co)
        res = self.split_register_relative(merged, range(ncr))
        self._cr = res.remaining
        return res.selected, r

    def condition_with(self, cr: Register) -> "Conditioned":
        return Conditioned(self, cr)

    # -- subcircuits under condition (ref conditioning.rs:210-275) -----------
    def make_subcircuit(self) -> List[PipelineItem]:
        return self.parent.make_subcircuit()

    def apply_subcircuit(self, sc: List[PipelineItem], r: Register) -> Register:
        cr = self._take_cr()
        cr, r = self.parent.apply_conditioned_subcircuit(sc, cr, r)
        self._cr = cr
        return r

    def apply_conditioned_subcircuit(
        self, sc: List[PipelineItem], cr: Register, r: Register
    ) -> Tuple[Register, Register]:
        ncr = cr.n
        ccr = self._take_cr()
        merged = self.merge_two_registers(cr, ccr)
        merged, r = self.parent.apply_conditioned_subcircuit(sc, merged, r)
        res = self.split_register_relative(merged, range(ncr))
        self._cr = res.remaining
        return res.selected, r

    # -- inversion passthrough (ref conditioning.rs:239-251) -----------------
    def new_similar(self):
        return self.parent.new_similar()

    @staticmethod
    def invert_subcircuit(sc: List[PipelineItem]) -> List[PipelineItem]:
        from rustqip_tpu_torch.builder.builder import LocalBuilder

        return LocalBuilder.invert_subcircuit(sc)

    def apply_inverted_subcircuit(
        self, sc: List[PipelineItem], r: Register
    ) -> Register:
        return self.apply_subcircuit(self.invert_subcircuit(sc), r)

    # -- measurements cannot be conditioned ----------------------------------
    def measure(self, r: Register):
        raise CircuitError("Cannot condition measurements.")

    def measure_stochastic(self, r: Register):
        raise CircuitError("Cannot condition measurements.")
