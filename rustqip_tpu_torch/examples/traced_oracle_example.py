"""Port twin of ``examples/traced_oracle_example.py``: a traced-function
oracle at a width no lookup table could embed.

A 22-qubit classical oracle, "which x satisfies (a*x + c) mod 2^22 ==
target?", applied as ONE FnOp whose entries are computed per block of the
state at apply time (the lazy-streaming analog of the reference's
``FunctionOpIterator``, qip-iterators/src/iterators/qubit_iterators.rs:223).
A table-based oracle at this width would hold a 4M-entry table; the
function op holds nothing.

The demo marks the unique solution with a phase flip, runs a few Grover
rounds, and reads the amplification: a small round count for demo speed,
not full sqrt(N) convergence. ``N``, ``A``, ``C`` and ``TARGET`` are module
globals, read when ``main`` runs.

    python -m rustqip_tpu_torch.examples.traced_oracle_example
"""

import numpy as np
import torch

from rustqip_tpu_torch.prelude import LocalBuilder

N = 22
A, C = 2_654_435_761 % (1 << N) | 1, 0x2B7E5  # odd multiplier: bijective
TARGET = 0x155555


def solution() -> int:
    """Classical inverse: x = a^-1 (target - c) mod 2^N."""
    a_inv = pow(A, -1, 1 << N)
    return (a_inv * (TARGET - C)) % (1 << N)


def phase_oracle(row):
    """fn(row) -> (col, val): identity permutation, -1 phase on the
    solution row, a diagonal function op (row is the op-local big-endian
    index; the register is applied whole, so row == register index).
    ``row`` is int32 and ``A * row`` needs 44 bits, so the product is
    taken in int64: the same residues mod 2^N as the JAX package's int32
    wraparound."""
    hit = ((A * row.long() + C) % (1 << N)) == TARGET
    return row, torch.where(hit, -1.0, 1.0)  # diagonal=True: no gather


def diffusion(b, r):
    r = b.h(r)
    r = b.apply_fn_matrix(
        r,
        lambda row: (row, torch.where(row == 0, 1.0, -1.0)),
        tag="flip-all-but-zero",
        diagonal=True,
    )
    return b.h(r)


def main(device="cuda"):
    b = LocalBuilder(dtype="f32", device=device)
    r = b.h(b.register(N))
    for _ in range(3):
        r = b.apply_fn_matrix(
            r, phase_oracle, tag="affine-hit", diagonal=True
        )
        r = diffusion(b, r)
    state, _ = b.calculate_state(seed=0)
    s = np.asarray(state).astype(np.complex128)
    probs = np.abs(s) ** 2

    # The oracle's row index is BIG-endian over the register's qubits;
    # state index == row index when the op spans the whole register.
    x = solution()
    amplified = float(probs[x])
    baseline = 1.0 / (1 << N)
    print(f"solution x = {x:#x}; p = {amplified:.3e} "
          f"({amplified / baseline:.0f}x uniform after 3 rounds)")
    assert amplified > 30 * baseline
    return {"x": x, "p": amplified}


if __name__ == "__main__":
    main()
