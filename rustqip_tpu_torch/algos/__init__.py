"""Algorithm library (L4): the QFT and Grover search."""

from rustqip_tpu_torch.algos.grover import grover_iteration, grover_search
from rustqip_tpu_torch.algos.qfft import qfft, qfft_inverse

__all__ = ["qfft", "qfft_inverse", "grover_iteration", "grover_search"]
