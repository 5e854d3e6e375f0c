"""Reference of the exact-phase QPE configurations (MQT Bench
``qpeexact``).

m counting qubits (qubits 0 .. m - 1), one target qubit (qubit m) set to
|1>, and U = diag(1, e^{2 pi i j / 2^b}) with b = m phase bits and j odd,
so the phase needs every bit. ``solve`` runs the textbook circuit gate by
gate on the whole m + 1 qubit state (``statevec``): X on the target, H on
every counting qubit, counting qubit q controlling U^(2^(m-1-q)) (a
controlled phase on the target), the inverse QFT of the counting
register, and the distribution of the counting register's outcomes.

A job's answer is the collapse of the counting register: its outcome as
the port's builder returns it (register qubit q in bit q of the value)
and its probability. The phase is exact, so the reference's answer is
certain: ``outcome_miss`` is 1 where the outcome is not the reference's
(an exact comparison), and ``prob_gap`` is the distance of the reported
probability from the reference's probability of the same outcome. The
answer also has a closed form (``closed_numbers``), which judges every
job of a window at no cost: the register reads j, so the builder's value
is j with its m bits reversed, at probability 1 (every other outcome at
0). The control runs the same circuit in TF32 and draws its outcome from
its own distribution.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import statevec
from portbench.reference.precision import EXACT, TF32

#: The limit of each number compared (readings and reasons: PERF.md).
LIMITS = {"outcome_miss": 0, "prob_gap": 1e-4}


def draw_params(cfg: dict, rng: np.random.Generator) -> dict:
    """An odd phase integer j in [1, 2^b): the eigenphase j / 2^b needs
    all b bits, so every controlled power is a different, nontrivial
    phase for every seed."""
    bits = int(cfg["phase_bits"])
    return {"phase_int": int(rng.integers(0, 1 << (bits - 1))) * 2 + 1}


def _sizes(cfg: dict):
    m, k = int(cfg["counting_qubits"]), int(cfg["target_qubits"])
    if k != 1 or int(cfg["phase_bits"]) != m or int(cfg["num_qubits"]) != m + k:
        raise ValueError("the qpe reference serves m counting qubits, b = m phase bits "
                         "and one target qubit")
    return m, k


def flip(m: int, v: int) -> int:
    """The big-endian register index of the builder's outcome value ``v``
    (register qubit q in bit q of ``v``), and back."""
    return int(format(int(v), f"0{m}b")[::-1], 2)


def solve(cfg: dict, params: dict, init: int, arith: str = EXACT, device="cpu") -> dict:
    m, k = _sizes(cfg)
    n = m + k
    j, bits = int(params["phase_int"]), int(cfg["phase_bits"])
    psi = statevec.basis(n, init, arith, device)
    for t in range(m, n):
        psi = statevec.x(psi, n, t)
    for q in range(m):
        psi = statevec.gate1(psi, n, q, statevec.H, arith)
    for q in range(m):
        # U^(2^(m-1-q)) = diag(1, e^{2 pi i (j 2^(m-1-q) mod 2^b) / 2^b})
        turns = (j << (m - 1 - q)) % (1 << bits)
        psi = statevec.cphase(psi, n, q, m, 2.0 * np.pi * turns / (1 << bits), arith)
    psi = statevec.qft(psi, n, range(m), arith, inverse=True)
    p = statevec.probs(psi, n, m)
    del psi
    top = int(p.argmax())
    return {"m": m, "probs": p, "arith": arith, "top": top, "top_prob": float(p[top])}


def numbers(cfg: dict, ref: dict, job) -> dict:
    if ref["top_prob"] < 0.5:
        raise ValueError(f"the reference's answer is not certain (p = {ref['top_prob']})")
    y = flip(ref["m"], job.answer["outcome"])
    return {"outcome_miss": float(y != ref["top"]),
            "prob_gap": abs(float(job.answer["prob"]) - float(ref["probs"][y]))}


def closed_numbers(cfg: dict, job) -> dict:
    """``outcome_miss`` and ``prob_gap`` of a job against the closed form:
    outcome ``flip(m, j)`` at probability 1."""
    m, _ = _sizes(cfg)
    hit = flip(m, job.answer["outcome"]) == int(job.params["phase_int"])
    return {"outcome_miss": float(not hit),
            "prob_gap": abs(float(job.answer["prob"]) - (1.0 if hit else 0.0))}


def control_answer(cfg: dict, ref: dict, job, rng: np.random.Generator) -> dict:
    """The collapse the TF32 reference gives in the program's place: an
    outcome drawn from its own distribution, and that outcome's
    probability."""
    if "cdf" not in ref:
        ref["cdf"] = torch.cumsum(ref["probs"].double(), 0).cpu().numpy()
    cdf = ref["cdf"]
    y = min(int(np.searchsorted(cdf, rng.random() * cdf[-1], side="right")), cdf.size - 1)
    return {"outcome": flip(ref["m"], y), "prob": float(ref["probs"][y])}
