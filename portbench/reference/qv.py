"""Reference of the quantum volume configurations (Cross, Bishop, Sheldon,
Nation and Gambetta, Phys. Rev. A 100, 032328 (2019), arXiv:1811.12926;
Qiskit's ``QuantumVolume``).

A model circuit of width n and depth d: each of the d layers draws a
uniformly random permutation of the n qubits, cuts it into n // 2 pairs,
and applies an independent Haar-random SU(4) to each pair. The circuit
starts from |0...0>. ``model_circuit`` draws the pairs from the
configuration's ``pairs_seed`` and the unitaries from the job's
``circuit_seed``; the program's builder (``circuits/qv.py``) and this
reference both call it, so both sides run the same circuit.

``solve`` runs the model circuit gate by gate on the whole state
(``gate2``: the textbook 4 x 4 product on a pair, in the arithmetic
``arith``); a job's amplitudes are judged by ``amp_gap``, the largest
distance of an amplitude read from the reference's, in units of
2^{-n/2}, the amplitudes' root-mean-square magnitude. The control is the
same circuit in TF32 (``precision.TF32``): the step below the float32 the
configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import statevec
from portbench.reference.precision import EXACT, operand

# the reference's float32 products (the control's) stay float32 on the card
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: The limit of each number compared (readings and reasons: PERF.md §2):
#: on an H100 the program read at most 5.5e-5 over 29 seeds at n = 28, the
#: TF32 control at least 1.65e-2 over 9 seeds, and the tile path with B
#: rounded to TF32 (``limits.py --plant tf32_b``) 5.4e-3 and more; 1e-3 lies
#: 18x above the first and 16.5x under the second.
LIMITS = {"amp_gap": 1e-3}


def haar_su4(rng: np.random.Generator) -> np.ndarray:
    """A Haar-random 4 x 4 unitary (Mezzadri, "How to generate random
    matrices from the classical compact groups", Notices AMS 54, 2007):
    the Q of a complex Ginibre matrix's QR with the phases of R's diagonal
    divided out, scaled to determinant 1; complex128."""
    z = (rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))) / np.sqrt(2.0)
    q, r = np.linalg.qr(z)
    d = np.diagonal(r)
    q = q * (d / np.abs(d))
    return q / np.linalg.det(q) ** 0.25


def model_circuit(n: int, depth: int, pairs_seed: int, circuit_seed: int):
    """The model circuit: ``depth`` layers, each a list of n // 2 gates
    ``(a, c, U)`` on disjoint qubits, qubit ``a`` the more significant
    index bit of U's 4 x 4. The layers' permutations are drawn from
    ``pairs_seed`` (the circuit's shape, fixed by the configuration, as a
    model's architecture is) and the unitaries from ``circuit_seed`` (its
    weights, drawn from the run's seed)."""
    pairs = np.random.default_rng(np.random.SeedSequence(int(pairs_seed)))
    rng = np.random.default_rng(np.random.SeedSequence(int(circuit_seed)))
    layers = []
    for _ in range(int(depth)):
        perm = pairs.permutation(int(n))
        layers.append([(int(perm[2 * k]), int(perm[2 * k + 1]), haar_su4(rng))
                       for k in range(int(n) // 2)])
    return layers


def circuit(cfg: dict, params: dict):
    """``model_circuit`` of a configuration and a job's parameters."""
    return model_circuit(int(cfg["num_qubits"]), int(cfg["depth"]), int(cfg["pairs_seed"]),
                         int(params["circuit_seed"]))


def draw_params(cfg: dict, rng: np.random.Generator) -> dict:
    """The seed of the model circuit's unitaries: every job of a resident
    mix runs the circuit it gives."""
    return {"circuit_seed": int(rng.integers(0, 1 << 62))}


def gate2(psi: torch.Tensor, n: int, a: int, c: int, u: np.ndarray,
          arith: str = EXACT) -> torch.Tensor:
    """``u`` (4 x 4, qubit ``a`` its more significant bit) on qubits ``a``,
    ``c``; a new state. Each output quarter is the sum of the four input
    quarters times their entries of ``u``, every product's operands in
    ``arith``."""
    v = statevec._pair(psi, n, a, c)
    ut = operand(torch.as_tensor(np.asarray(u), dtype=psi.dtype, device=psi.device), arith)
    # the view's quarter (x, y) holds bits (min(a, c), max(a, c)); u's index is (a, c)
    at = (lambda x, y: 2 * x + y) if a < c else (lambda x, y: 2 * y + x)
    quarters = [(at(x, y), operand(v[:, x, :, y, :], arith)) for x in (0, 1) for y in (0, 1)]
    out = torch.empty_like(v)
    for x in (0, 1):
        for y in (0, 1):
            i = at(x, y)
            acc = None
            for j, q in quarters:
                term = q * ut[i, j]
                acc = term if acc is None else acc.add_(term)
            out[:, x, :, y, :] = acc
    return out.view(-1)


def state(n: int, layers, init: int = 0, arith: str = EXACT, device="cpu") -> torch.Tensor:
    """The state of a model circuit's ``layers`` from |init>, gate by gate."""
    psi = statevec.basis(n, init, arith, device)
    for layer in layers:
        for a, c, u in layer:
            psi = gate2(psi, n, a, c, u, arith)
    return psi


def solve(cfg: dict, params: dict, init: int, arith: str = EXACT, device="cpu") -> dict:
    n = int(cfg["num_qubits"])
    return {"n": n, "psi": state(n, circuit(cfg, params), init, arith, device)}


def _at(ref: dict, read) -> np.ndarray:
    idx = torch.as_tensor(np.asarray(read, dtype=np.int64), device=ref["psi"].device)
    return ref["psi"][idx].to(torch.complex128).cpu().numpy()


def numbers(cfg: dict, ref: dict, job) -> dict:
    """``amp_gap`` of a job's amplitudes (``job.answer["amps"]`` at
    ``job.read``)."""
    got = np.asarray(job.answer["amps"], dtype=np.complex128)
    return {"amp_gap": float(np.abs(got - _at(ref, job.read)).max() * 2.0 ** (ref["n"] / 2))}


def control_answer(cfg: dict, ref: dict, job, rng: np.random.Generator) -> dict:
    """The answer of the reference in the program's place: ``ref`` is the
    TF32 state (``limits.control_numbers`` solves in TF32)."""
    return {"amps": _at(ref, job.read)}
