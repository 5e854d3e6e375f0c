"""DSL layer (L3): textbook-notation circuit construction (port of
``rustqip_tpu/dsl``).

Python re-design of the reference proc-macros: ``program()`` replaces the
``program!`` macro (qip-macros/src/lib.rs:93-354) and ``@invertible``
replaces ``#[invert]`` (qip-macros/src/lib.rs:371-531). Python needs no
token parsing — register selectors are plain indexing on proxies, and
inversion is shadow-builder tracing at call time.
"""

from rustqip_tpu_torch.dsl.program import Program, program, negate_bitmask
from rustqip_tpu_torch.dsl.invert import invertible
from rustqip_tpu_torch.dsl import ops

__all__ = ["Program", "program", "negate_bitmask", "invertible", "ops"]
