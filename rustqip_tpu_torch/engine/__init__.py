"""Execution engine (L0): plans, the Hopper kernels, plain torch passes,
and the state-vector API (``apply_op``, ``apply_ops`` on flat complex
states) over them.

Its imports point one way, down: ``types`` (the plane format) imports no
module of the package; ``apply`` (host plans, plain passes) imports
``types``, ``errors``, ``utils.bits`` and ``ops.matrix_ops``; ``admission``
imports ``types``, and ``cuda_build`` (the one seam to the kernel libraries)
nothing of the package; the kernel wrappers (``window_kernel``,
``row_swap``, ``copy_probe``, ``monomial``) import those four (``monomial``
also ``ops.matrix_ops``, for the ops it checks); ``real_apply`` (planner,
dispatch, state-vector API) imports all of them and ``utils.observe``;
``compile`` imports ``real_apply``; ``builder`` and ``parallel`` import both.

Float32 matrix products here must run in full float32 (the TPU analog is
``engine/apply.py``'s ``MATMUL_PRECISION = HIGHEST``): TF32 keeps about
three decimal digits, which amplitude simulation cannot take. Importing the
engine sets both switches explicitly.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from rustqip_tpu_torch.engine.real_apply import (  # noqa: E402
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
