"""Reference of Shor's order-finding configurations (Nielsen and Chuang,
Quantum Computation and Quantum Information (2010), §5.3.1), in the form
the port's ``algos.shor.shor_period_circuit`` builds.

t counting qubits (qubits 0 .. t - 1) and an L-qubit work register (qubits
t .. t + L - 1, its value's bit j on qubit t + j) set to |1>; counting qubit
j controls U^(2^j), U|y> = |a y mod N> (the identity on y >= N); then the
inverse QFT of the counting register, whose outcome distribution is the
answer. ``solve`` runs that circuit gate by gate on the whole state, in
place, in blocks of ``BLOCK`` amplitudes: X, every H, each controlled
multiplication as a permutation of the work register's values on the half
of the state its control selects, the inverse QFT (``statevec.qft``'s
gates), and the counting register's distribution. At 31 qubits the state
is 32 GiB in complex128 and a block adds 1 GiB; it runs after the window,
once the program's planes are freed.

The circuit's bit order is the JAX package's, carried over by the port:
counting qubit j, which controls the power 2^j, is bit t - 1 - j of the
big-endian index X that the inverse QFT reads, so the exponent is
x = rev(X), the t bits of X reversed. The counting register's distribution
is then not the textbook's peaks at multiples of 2^t / r, but it has a
closed form all the same (``closed_form``), which judges every job of a
window: after the multiplications the state is
sum_x |rev(x)> |a^x mod N>, the work register's value depends on x mod r
alone, so for each residue s the counting register holds the indicator of
{X : rev(X) = s mod r}, and P(y) = sum_s |DFT of that indicator at y|^2 /
2^(2t), with r the order of a. The port's outcome value v holds counting
qubit q in bit q, so it reads the big-endian index ``flip(t, v)``.

The number compared is ``dist_gap``: the largest distance of a job's
probability from the reference's over all 2^t outcomes, in units of the
reference's P(0), the height of the distribution's tallest peak (about
1/r): the float32 program's error and the TF32 control's both scale with
it, so one limit serves every base. The control runs the same circuit in
TF32 (``precision.TF32``) and answers with its own distribution.

Which of a permutation and its inverse a multiplication applies leaves
the distribution unchanged (after the multiplications the state is
sum_x |rev(x)> |a^(+-x)>, whose residues repeat with the same order), so a
run of the cell cannot tell them apart: the port's tests hold the state
itself.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from portbench.reference import statevec
from portbench.reference.precision import EXACT, complex_dtype, operand

#: The limit of each number compared (readings and reasons: PERF.md §2):
#: on an H100 the program read at most 6.9e-7 over 14 seeds at 31 qubits,
#: the TF32 control at least 2.2e-3 over 3 seeds; 1e-4 lies 145x above the
#: first and 22x under the second.
LIMITS = {"dist_gap": 1e-4}
#: Amplitudes a block of ``solve`` works on at once (1 GiB of complex128).
BLOCK = 1 << 26
#: Residues whose indicators ``closed_form`` transforms at once.
FFT_BATCH = 16


def order(a: int, N: int) -> int:
    """The multiplicative order of ``a`` mod ``N`` (gcd(a, N) = 1)."""
    r, x = 1, a % N
    while x != 1:
        x = x * a % N
        r += 1
    return r


@lru_cache(maxsize=8)
def bases(N: int):
    """The bases coprime to ``N`` whose order is not a power of two: for
    these, a^(2^j) is never 1, so every controlled multiplication of the
    circuit is a nontrivial permutation (none is left out) and every base
    plans the same sweeps."""
    out = []
    for a in range(2, N - 1):
        if math.gcd(a, N) == 1:
            r = order(a, N)
            if r & (r - 1):
                out.append(a)
    return tuple(out)


def draw_params(cfg: dict, rng: np.random.Generator) -> dict:
    """A base drawn uniformly from ``bases``: every job of a resident mix
    runs the circuit it gives."""
    pool = bases(int(cfg["modulus"]))
    return {"base": int(pool[int(rng.integers(0, len(pool)))])}


def _sizes(cfg: dict):
    t, L, N = int(cfg["counting_qubits"]), int(cfg["work_qubits"]), int(cfg["modulus"])
    if int(cfg["num_qubits"]) != t + L or N.bit_length() != L:
        raise ValueError("the shor reference serves t counting qubits and an L-qubit work "
                         "register, L the bit length of the modulus")
    return t, L, N


def flip(t: int, v):
    """The big-endian counting-register index of the port's outcome value
    ``v`` (counting qubit q in bit q of ``v``), and back; ``v`` an int or
    an int64 array."""
    v = np.asarray(v, dtype=np.int64)
    out = np.zeros_like(v)
    for q in range(t):
        out |= ((v >> q) & 1) << (t - 1 - q)
    return out


def closed_form(t: int, r: int, device=None) -> np.ndarray:
    """P over the port's 2^t outcome values (float64): for each residue s
    of the exponent mod r, the squared DFT of the indicator of the
    big-endian indices X with rev(X) = s mod r, summed, over 2^(2t). The
    indicators' real transforms run ``FFT_BATCH`` at a time on ``device``
    (the card where there is one)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    T = 1 << t
    res = torch.as_tensor(flip(t, np.arange(T, dtype=np.int64)) % r, device=device)
    half = torch.zeros(T // 2 + 1, dtype=torch.float64, device=device)
    for s0 in range(0, r, FFT_BATCH):
        s = torch.arange(s0, min(r, s0 + FFT_BATCH), device=device)
        ind = (res[None, :] == s[:, None]).to(torch.float64)
        half += torch.fft.rfft(ind, dim=1).abs().square().sum(dim=0)
    half = half.cpu().numpy()
    by_index = np.concatenate([half, half[1:T - T // 2][::-1]]) / float(T) ** 2
    return by_index[flip(t, np.arange(T, dtype=np.int64))]


@lru_cache(maxsize=4)
def _closed(t: int, r: int) -> np.ndarray:
    return closed_form(t, r)


def _blocks(A: int, M: int, B: int):
    """Index tuples that cut an (A, M, B) view into pieces of at most
    ``BLOCK`` elements, never cutting the last axis below B."""
    if M * B <= BLOCK:
        step = max(1, BLOCK // (M * B))
        for a0 in range(0, A, step):
            yield (slice(a0, a0 + step),)
    elif B <= BLOCK:
        step = BLOCK // B
        for a in range(A):
            for m0 in range(0, M, step):
                yield (a, slice(m0, m0 + step))
    else:
        for a in range(A):
            for m in range(M):
                for b0 in range(0, B, BLOCK):
                    yield (a, m, slice(b0, b0 + BLOCK))


def _halves(psi: torch.Tensor, n: int, q: int):
    """The (A, 1, B) views of qubit ``q`` at 0 and at 1."""
    v = psi.view(1 << q, 2, 1 << (n - q - 1))
    return v[:, 0:1, :], v[:, 1:2, :]


def _quarters(psi: torch.Tensor, n: int, a: int, b: int):
    """The (A, M, B) views of qubits a < b at (0, 1), (1, 0) and (1, 1)."""
    v = psi.view(1 << a, 2, 1 << (b - a - 1), 2, 1 << (n - b - 1))
    return v[:, 0, :, 1, :], v[:, 1, :, 0, :], v[:, 1, :, 1, :]


def gate1(psi: torch.Tensor, n: int, q: int, u: np.ndarray, arith: str) -> None:
    """``statevec.gate1`` in place, block by block."""
    lo, hi = _halves(psi, n, q)
    ut = operand(torch.as_tensor(np.asarray(u), dtype=psi.dtype, device=psi.device), arith)
    for idx in _blocks(*lo.shape):
        a, b = operand(lo[idx], arith), operand(hi[idx], arith)
        out0 = a * ut[0, 0] + b * ut[0, 1]
        hi[idx] = a * ut[1, 0] + b * ut[1, 1]
        lo[idx] = out0


def x(psi: torch.Tensor, n: int, q: int) -> None:
    """NOT on qubit ``q`` in place (a permutation: no arithmetic)."""
    lo, hi = _halves(psi, n, q)
    for idx in _blocks(*lo.shape):
        tmp = lo[idx].clone()
        lo[idx] = hi[idx]
        hi[idx] = tmp


def swap(psi: torch.Tensor, n: int, a: int, b: int) -> None:
    """SWAP of qubits ``a`` and ``b`` in place (a permutation)."""
    if a == b:
        return
    q01, q10, _ = _quarters(psi, n, min(a, b), max(a, b))
    for idx in _blocks(*q01.shape):
        tmp = q01[idx].clone()
        q01[idx] = q10[idx]
        q10[idx] = tmp


def cphase(psi: torch.Tensor, n: int, a: int, b: int, theta: float, arith: str) -> None:
    """``statevec.cphase`` (diag(1, 1, 1, e^{i theta}) on ``a``, ``b``) in
    place, block by block."""
    _, _, q11 = _quarters(psi, n, min(a, b), max(a, b))
    ph = operand(torch.tensor(complex(np.cos(theta), np.sin(theta)), dtype=psi.dtype,
                              device=psi.device), arith)
    for idx in _blocks(*q11.shape):
        q11[idx] = operand(q11[idx], arith) * ph


def iqft(psi: torch.Tensor, n: int, m: int, arith: str) -> None:
    """``statevec.qft(..., inverse=True)`` on qubits 0 .. m - 1, in place:
    the reversal swaps, then for each qubit from the last the conjugated
    controlled phases and H."""
    for i in range(m // 2):
        swap(psi, n, i, m - 1 - i)
    for i in reversed(range(m)):
        for j in reversed(range(i + 1, m)):
            cphase(psi, n, i, j, -np.pi / (1 << (j - i)), arith)
        gate1(psi, n, i, statevec.H, arith)


def modmul(psi: torch.Tensor, n: int, t: int, j: int, c: int, N: int) -> None:
    """Counting qubit ``j`` controlling |y> -> |c y mod N> (y < N; the
    identity above) on the work register, in place: on the half of the
    state where qubit j is 1, each block's work axis is gathered from the
    index whose value c^-1 y maps to y."""
    L = n - t
    dim = 1 << L
    ys = np.arange(dim)
    cinv = pow(c, -1, N)
    src_y = np.where(ys < N, (ys * cinv) % N, ys)
    # the work axis is big-endian over qubits t .. n - 1: value bit i on index bit L - 1 - i
    idx_of = flip(L, ys)
    src = np.empty(dim, dtype=np.int64)
    src[idx_of] = idx_of[src_y]
    src_t = torch.as_tensor(src, device=psi.device)
    half = psi.view(1 << j, 2, 1 << (t - 1 - j), dim)[:, 1]
    for idx in _blocks(*half.shape):
        half[idx] = half[idx][..., src_t]


def solve(cfg: dict, params: dict, init: int, arith: str = EXACT, device="cpu") -> dict:
    t, L, N = _sizes(cfg)
    n = t + L
    a = int(params["base"])
    psi = torch.zeros(1 << n, dtype=complex_dtype(arith), device=device)
    psi[int(init)] = 1.0
    x(psi, n, t)  # the work register's value bit 0
    for q in range(t):
        gate1(psi, n, q, statevec.H, arith)
    for j in range(t):
        modmul(psi, n, t, j, pow(a, 1 << j, N), N)
    iqft(psi, n, t, arith)
    rows = psi.view(1 << t, 1 << L)
    probs = torch.empty(1 << t, dtype=torch.float64, device=device)
    for idx in _blocks(1 << t, 1, 1 << L):
        blk = rows[idx]
        probs[idx] = (blk.real.double() ** 2 + blk.imag.double() ** 2).sum(dim=1)
    del psi, rows
    p = probs.cpu().numpy()
    return {"t": t, "r": order(a, N), "probs": p[flip(t, np.arange(1 << t, dtype=np.int64))]}


def _gap(got, want: np.ndarray) -> float:
    """The largest distance of ``got`` from ``want``, over ``want``'s P(0)."""
    got = np.asarray(got, dtype=np.float64).reshape(-1)
    if got.shape != want.shape:
        return math.inf
    return float(np.abs(got - want).max() / want[0])


def numbers(cfg: dict, ref: dict, job) -> dict:
    """``dist_gap`` of a job's distribution against the reference's."""
    return {"dist_gap": _gap(job.answer["probs"], ref["probs"])}


def closed_numbers(cfg: dict, job) -> dict:
    """``dist_gap`` of a job's distribution against the closed form."""
    t, _, N = _sizes(cfg)
    return {"dist_gap": _gap(job.answer["probs"], _closed(t, order(int(job.params["base"]), N)))}


def control_answer(cfg: dict, ref: dict, job, rng: np.random.Generator) -> dict:
    """The distribution of the reference in the program's place: ``ref``
    is the TF32 run (``limits.control_numbers`` solves in TF32)."""
    return {"probs": ref["probs"]}
