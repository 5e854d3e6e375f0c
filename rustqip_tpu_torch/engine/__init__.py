"""Execution engine (L0): plans, the Hopper kernels, plain torch passes.

Float32 matrix products here must run in full float32 (the TPU analog is
``engine/apply.py``'s ``MATMUL_PRECISION = HIGHEST``): TF32 keeps about
three decimal digits, which amplitude simulation cannot take. Importing the
engine sets both switches explicitly.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
