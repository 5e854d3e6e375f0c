"""Circuit-builder layer (L2): the user-facing circuit construction API."""

from rustqip_tpu_torch.builder.builder import (
    LocalBuilder,
    MeasurementHandle,
    Measurements,
    StochasticMeasurementHandle,
)
from rustqip_tpu_torch.builder.circuit_objects import (
    CircuitObject,
    ControlledMatGate,
    GlobalPhaseGate,
    MatGate,
    MeasurementObject,
    NamedGate,
    RzGate,
    UnitaryObject,
    invert_circuit_object,
)
from rustqip_tpu_torch.builder.conditioning import Conditioned
from rustqip_tpu_torch.builder.inverter import inverter, inverter_args
from rustqip_tpu_torch.builder.registers import (
    Register,
    SplitManyResult,
    SplitResult,
)
from rustqip_tpu_torch.builder.traits import make_circuit_matrix

__all__ = [
    "LocalBuilder",
    "Conditioned",
    "Register",
    "SplitResult",
    "SplitManyResult",
    "CircuitObject",
    "UnitaryObject",
    "NamedGate",
    "RzGate",
    "MatGate",
    "ControlledMatGate",
    "GlobalPhaseGate",
    "MeasurementObject",
    "invert_circuit_object",
    "Measurements",
    "MeasurementHandle",
    "StochasticMeasurementHandle",
    "inverter",
    "inverter_args",
    "make_circuit_matrix",
]
