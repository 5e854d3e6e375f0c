"""rustqip_tpu_torch — the PyTorch / CUDA port of ``rustqip_tpu``.

A quantum state-vector simulator with the JAX package's circuit surface,
running on (re, im) float planes in PyTorch, with the JAX package's Pallas
kernels rewritten by hand in CUDA C++ for Hopper (``csrc/``: the
strip-window kernel, the row-swap pass, the plane copy). The JAX package
stays the reference the port is held against; this package imports neither
it nor JAX.

Layer map (the JAX package's, path for path):
  engine/    L0  kernels + wrappers, planner, plain torch passes, compile
  ops/       L1  op IR + constructors, measurement
  builder/   L2  LocalBuilder, registers, conditioning, inverter
  dsl/       L3  program, invertible, ops
  algos/     L4  qfft, arithmetic, grover, phase estimation, shor
  qasm/          OpenQASM 2.0 export and import
  utils/         bit math, serialization (JSON), observability (profilers,
                 torch.profiler trace)
  interop.py     ops and states to and from the JAX package (duck-typed)

The native C++ CPU engine (``engine/cpu_native.py``, ``csrc/qip_engine.cpp``)
is an oracle independent of torch and the CPU baseline.
"""

from rustqip_tpu_torch.errors import CircuitError
from rustqip_tpu_torch.types import PiRational, Representation

__version__ = "0.1.0"

__all__ = ["CircuitError", "PiRational", "Representation"]
