"""rustqip_tpu_torch — the PyTorch / CUDA port of ``rustqip_tpu``.

A quantum state-vector simulator with the JAX package's circuit surface,
running on (re, im) float planes in PyTorch, with the JAX package's Pallas
strip-window kernel rewritten by hand in CUDA C++ for Hopper
(``csrc/window_sweep.cu``). The JAX package stays the reference the port is
held against; this package imports neither it nor JAX.

Layer map (the JAX package's, path for path):
  engine/    L0  window kernel + wrapper, planner, plain torch passes, compile
  ops/       L1  op IR + constructors, measurement
  builder/   L2  LocalBuilder, registers, conditioning
  dsl/       L3  negate_bitmask (the rest waits)
  algos/     L4  qfft, grover
  interop.py     ops and states to and from the JAX package (duck-typed)
"""

from rustqip_tpu_torch.errors import CircuitError
from rustqip_tpu_torch.types import PiRational, Representation

__version__ = "0.1.0"

__all__ = ["CircuitError", "PiRational", "Representation"]
