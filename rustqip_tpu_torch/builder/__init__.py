"""Circuit-builder layer (L2): the user-facing circuit construction API."""

from rustqip_tpu_torch.builder.builder import (
    LocalBuilder,
    MeasurementHandle,
    Measurements,
    StochasticMeasurementHandle,
)
from rustqip_tpu_torch.builder.conditioning import Conditioned
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
    "Measurements",
    "MeasurementHandle",
    "StochasticMeasurementHandle",
    "make_circuit_matrix",
]
