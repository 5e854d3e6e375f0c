"""A plain state-vector simulator in PyTorch, gate by gate.

The state of n qubits is a flat complex tensor of 2^n amplitudes on
big-endian indices: qubit q is bit n - 1 - q of the index, as in the
port's builder. Every gate is applied as its textbook definition, in the
arithmetic ``arith`` (``precision.EXACT`` in complex128, or
``precision.TF32`` in complex64 with each product's operands rounded to
TF32). Axes are grouped into at most five dimensions, so any n works.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.precision import EXACT, complex_dtype, operand

H = np.array([[1, 1], [1, -1]], dtype=np.complex128) / np.sqrt(2.0)


def basis(n: int, index: int, arith: str = EXACT, device="cpu") -> torch.Tensor:
    psi = torch.zeros(1 << n, dtype=complex_dtype(arith), device=device)
    psi[int(index)] = 1.0
    return psi


def _axis(psi: torch.Tensor, n: int, q: int) -> torch.Tensor:
    return psi.view(1 << q, 2, 1 << (n - q - 1))


def gate1(psi: torch.Tensor, n: int, q: int, u: np.ndarray, arith: str = EXACT) -> torch.Tensor:
    """``u`` (2 x 2) on qubit ``q``; a new state."""
    v = _axis(psi, n, q)
    ut = operand(torch.as_tensor(np.asarray(u), dtype=psi.dtype, device=psi.device), arith)
    a, b = operand(v[:, 0], arith), operand(v[:, 1], arith)
    out = torch.empty_like(v)
    torch.add(a * ut[0, 0], b * ut[0, 1], out=out[:, 0])
    torch.add(a * ut[1, 0], b * ut[1, 1], out=out[:, 1])
    return out.view(-1)


def x(psi: torch.Tensor, n: int, q: int) -> torch.Tensor:
    """NOT on qubit ``q`` (a permutation: no arithmetic); a new state."""
    return _axis(psi, n, q).flip(1).reshape(-1)


def _pair(psi: torch.Tensor, n: int, a: int, b: int) -> torch.Tensor:
    a, b = min(a, b), max(a, b)
    return psi.view(1 << a, 2, 1 << (b - a - 1), 2, 1 << (n - b - 1))


def cphase(psi: torch.Tensor, n: int, a: int, b: int, theta: float, arith: str = EXACT) -> torch.Tensor:
    """diag(1, 1, 1, e^{i theta}) on qubits ``a``, ``b``, in place."""
    sel = _pair(psi, n, a, b)[:, 1, :, 1, :]
    ph = operand(torch.tensor(complex(np.cos(theta), np.sin(theta)), dtype=psi.dtype,
                              device=psi.device), arith)
    sel.copy_(operand(sel, arith) * ph)
    return psi


def swap(psi: torch.Tensor, n: int, a: int, b: int) -> torch.Tensor:
    """SWAP of qubits ``a`` and ``b`` (a permutation); a new state."""
    if a == b:
        return psi
    return _pair(psi, n, a, b).transpose(1, 3).reshape(-1)


def qft(psi: torch.Tensor, n: int, qubits, arith: str = EXACT, inverse: bool = False):
    """The textbook QFT circuit on ``qubits`` (big-endian within them: the
    DFT F[j, k] = e^{2 pi i j k / 2^m} / 2^{m/2}): H and controlled phases
    pi / 2^(j - i), then the reversal swaps. ``inverse`` runs the inverse
    circuit (the gates reversed, each phase conjugated)."""
    qs = list(qubits)
    m = len(qs)
    if not inverse:
        for i in range(m):
            psi = gate1(psi, n, qs[i], H, arith)
            for j in range(i + 1, m):
                psi = cphase(psi, n, qs[i], qs[j], np.pi / (1 << (j - i)), arith)
        for i in range(m // 2):
            psi = swap(psi, n, qs[i], qs[m - 1 - i])
        return psi
    for i in range(m // 2):
        psi = swap(psi, n, qs[i], qs[m - 1 - i])
    for i in reversed(range(m)):
        for j in reversed(range(i + 1, m)):
            psi = cphase(psi, n, qs[i], qs[j], -np.pi / (1 << (j - i)), arith)
        psi = gate1(psi, n, qs[i], H, arith)
    return psi


def probs(psi: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """The outcome distribution of the first ``m`` qubits (big-endian
    index over them), in float64."""
    mag = psi.view(1 << m, 1 << (n - m))
    return (mag.real.double() ** 2 + mag.imag.double() ** 2).sum(dim=1)
