"""Execution engine (L0): plans, the Hopper kernels, plain torch passes,
and the state-vector API (``apply_op``, ``apply_ops`` on flat complex
states) over them.

Float32 matrix products here must run in full float32 (the TPU analog is
``engine/apply.py``'s ``MATMUL_PRECISION = HIGHEST``): TF32 keeps about
three decimal digits, which amplitude simulation cannot take. Importing the
engine sets both switches explicitly.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from rustqip_tpu_torch.engine.apply import (  # noqa: E402
    apply_op,
    apply_op_add,
    apply_ops,
    as_tensor,
    as_vector,
)
from rustqip_tpu_torch.engine.fusion import fuse_ops  # noqa: E402
from rustqip_tpu_torch.engine.compile import CompiledCircuit, compile_pipeline  # noqa: E402

__all__ = [
    "apply_op",
    "apply_op_add",
    "apply_ops",
    "as_tensor",
    "as_vector",
    "fuse_ops",
    "CompiledCircuit",
    "compile_pipeline",
]
