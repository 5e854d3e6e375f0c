"""Convenience prelude (ref ``qip::prelude``, qip/src/lib.rs:271-279)."""

from rustqip_tpu_torch.builder import (
    Conditioned,
    LocalBuilder,
    MeasurementHandle,
    Measurements,
    Register,
    SplitManyResult,
    SplitResult,
    StochasticMeasurementHandle,
    inverter,
    inverter_args,
    make_circuit_matrix,
)
from rustqip_tpu_torch.errors import CircuitError
from rustqip_tpu_torch.ops.measurement_ops import MeasuredCondition
from rustqip_tpu_torch.types import PiRational, Representation

__all__ = [
    "LocalBuilder",
    "Conditioned",
    "Register",
    "SplitResult",
    "SplitManyResult",
    "Measurements",
    "MeasurementHandle",
    "StochasticMeasurementHandle",
    "inverter",
    "inverter_args",
    "make_circuit_matrix",
    "CircuitError",
    "MeasuredCondition",
    "PiRational",
    "Representation",
]
