"""Reference of the QFT configurations: the DFT of a basis state.

The QFT of the basis state |x> on n qubits is, by definition,
sum_k e^{2 pi i x k / 2^n} / 2^{n/2} |k> on big-endian indices (the
textbook circuit of ``statevec.qft`` computes the same; a CPU test holds
the two together). ``solve`` gives that column of the DFT; a job's
amplitudes are judged by ``amp_gap``, the largest distance of an amplitude
read from it, in units of the amplitudes' common magnitude 2^{-n/2}.

The control is the same DFT as a TF32 product (the one-hot input times
the DFT's matrix, whose entries a TF32 product rounds to 10 mantissa
bits): the step below the float32 the configuration states.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.precision import EXACT, TF32, round_tf32_np

#: The limit of each number compared (readings and reasons: PERF.md).
LIMITS = {"amp_gap": 3e-5}


def draw_params(cfg: dict, rng: np.random.Generator) -> dict:
    """The QFT has no parameter: every job runs the same circuit."""
    return {}


def amplitudes(n: int, x: int, ks: np.ndarray, arith: str = EXACT) -> np.ndarray:
    """Amplitudes k of the QFT of |x>, complex128 (in ``arith``)."""
    k = np.asarray(ks, dtype=np.uint64)
    # x * k mod 2^n, exact: the uint64 product wraps mod 2^64, a multiple of 2^n
    xk = (np.uint64(x) * k) & np.uint64((1 << n) - 1)
    theta = xk.astype(np.float64) * (2.0 * np.pi / (1 << n))
    re, im = np.cos(theta), np.sin(theta)
    scale = 2.0 ** (-n / 2)
    if arith == TF32:
        re = round_tf32_np(re.astype(np.float32)).astype(np.float64)
        im = round_tf32_np(im.astype(np.float32)).astype(np.float64)
        scale = float(round_tf32_np(np.array([scale], dtype=np.float32))[0])
    elif arith != EXACT:
        raise ValueError(f"unknown arithmetic {arith!r}")
    return (re + 1j * im) * scale


def solve(cfg: dict, params: dict, init: int, arith: str = EXACT, device="cpu") -> dict:
    """The reference of a QFT job from |init>: its amplitudes are computed
    where a job reads them (``numbers``)."""
    return {"n": int(cfg["num_qubits"]), "x": int(init), "arith": arith}


def numbers(cfg: dict, ref: dict, job) -> dict:
    """``amp_gap`` of a job's amplitudes (``job.answer["amps"]`` at
    ``job.read``)."""
    n = ref["n"]
    want = amplitudes(n, ref["x"], job.read, ref["arith"])
    got = np.asarray(job.answer["amps"], dtype=np.complex128)
    return {"amp_gap": float(np.abs(got - want).max() * 2.0 ** (n / 2))}


def control_answer(cfg: dict, ref: dict, job, rng: np.random.Generator) -> dict:
    """The answer of the reference in the program's place, in TF32."""
    return {"amps": amplitudes(ref["n"], ref["x"], job.read, TF32)}
