"""Exact-phase QPE (``rustqip_tpu_torch.algos.phase_estimate``): m
counting qubits, a one-qubit target prepared in |1> by X, and
U = diag(1, e^{2 pi i j / 2^b}); the counting register is measured."""

import numpy as np

from rustqip_tpu_torch.algos import phase_estimate


def build(b, cfg: dict, params: dict) -> None:
    bits = int(cfg["phase_bits"])
    u = np.diag([1.0, np.exp(2j * np.pi * int(params["phase_int"]) / (1 << bits))])
    phase_estimate(b, u, int(cfg["counting_qubits"]), prepare=lambda bb, t: bb.x(t))
