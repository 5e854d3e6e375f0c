"""The kernel parity windows, built with the port's constructors.

Port of ``scripts/kernel_parity.py:55-201`` (``build_sequences``): ten op
sequences whose kernel windows together cover every step kind of the
window kernel (low, lowr, mix, rmix, diag, cbf, rbf, cmix). The CPU tests
plan them against the JAX package and ``chip_smoke.py`` holds the CUDA
kernel against its plain version on them. ``step_windows`` adds six
windows written directly as kernel steps, one per shape of the tensor-core
matrix steps and the separable diag.
"""

from __future__ import annotations

import numpy as np

from rustqip_tpu_torch.ops import gates
from rustqip_tpu_torch.ops.matrix_ops import (
    PhaseProductOp,
    make_control_op,
    make_matrix_op,
)

N = 20


def rand_u(k: int, seed: int) -> np.ndarray:
    """A seeded Haar-ish random 2^k x 2^k unitary (QR of a Gaussian)."""
    r = np.random.default_rng(seed)
    m = r.normal(size=(1 << k, 1 << k)) + 1j * r.normal(size=(1 << k, 1 << k))
    q, _ = np.linalg.qr(m)
    return q


def build_sequences(n: int = N):
    """[(name, ops, expected step kinds)] — the same ten windows as the
    JAX package's parity script."""
    H = gates.H.reshape(-1)
    T = gates.T.reshape(-1)
    X = gates.X.reshape(-1)

    def cp(a, b, ang):
        return PhaseProductOp(
            (((a, b), (1, 1, 1, complex(np.cos(ang), np.sin(ang)))),)
        )

    seqs = []
    seqs.append((
        "alternating",
        [make_matrix_op([(i % 2) * (n - 1)], H if i % 2 == 0 else T)
         for i in range(6)],
        {"mix", "cbf"},
    ))
    ops = []
    for i, q in enumerate((n - 1, n - 2, n - 3)):
        ops.append(make_matrix_op([q], H))
        for d, t in enumerate((3 + i, 5 + i)):
            ops.append(cp(t, q, np.pi / (2 << d)))
    seqs.append(("qft_ladder", ops, {"cbf", "diag"}))
    hh = np.kron(gates.H, gates.H)
    seqs.append((
        "dense_low",
        [
            make_matrix_op([n - 1, n - 2], rand_u(2, 11).reshape(-1)),
            make_matrix_op([0], gates.Z.reshape(-1)),
            make_matrix_op([n - 2, n - 3], hh.reshape(-1)),
            make_matrix_op([n - 1], T),
        ],
        {"low", "mix"},
    ))
    seqs.append((
        "rbf_pair",
        [
            make_matrix_op([n - 8], rand_u(1, 21).reshape(-1)),
            make_matrix_op([n - 10], H),
            make_matrix_op([n - 1], rand_u(1, 22).reshape(-1)),
        ],
        {"rbf", "cbf"},
    ))
    seqs.append((
        "mixed_all",
        [
            make_matrix_op([1], gates.X.reshape(-1)),
            cp(2, n - 2, 0.77),
            make_matrix_op([n - 2], rand_u(1, 32).reshape(-1)),
            make_matrix_op([n - 1, n - 3], rand_u(2, 31).reshape(-1)),
            make_matrix_op([n - 9], T),
            make_matrix_op([1], H),
        ],
        {"mix", "diag", "low", "cbf", "rbf"},
    ))
    seqs.append((
        "rmix_disjoint",
        [
            make_matrix_op([1, n - 6, n - 5], rand_u(3, 41).reshape(-1)),
            make_matrix_op([2, n - 4, n - 3], rand_u(3, 42).reshape(-1)),
        ],
        {"rmix"},
    ))
    ccx = np.eye(8, dtype=np.complex128)
    ccx[[6, 7]] = ccx[[7, 6]]
    seqs.append((
        "pure_mix_ccx",
        [make_matrix_op([3, 4, 5], ccx.reshape(-1))],
        {"mix"},
    ))
    seqs.append((
        "ctrl_butterfly",
        [
            make_control_op([0, 1], make_matrix_op([10], X)),
            make_control_op([10], make_matrix_op([n - 1], X)),
            make_control_op([2, n - 2], make_matrix_op([9], X)),
            make_control_op(
                [0, 3, 5, n - 3], make_matrix_op([n - 1], gates.Z.reshape(-1))
            ),
        ],
        {"cbf", "rbf"},
    ))
    seqs.append((
        "lone_rmix",
        [make_matrix_op([0, 1, n - 1], rand_u(3, 51).reshape(-1))],
        {"rmix"},
    ))
    seqs.append((
        "cmix_high_targets",
        [
            make_control_op([6, n - 2], make_matrix_op([0], X)),
            make_control_op(
                [4, 9, n - 1], make_matrix_op([1], gates.H.reshape(-1))
            ),
            make_control_op([2, 12], make_matrix_op([0], gates.Y.reshape(-1))),
        ],
        {"cmix"},
    ))
    return seqs


def lowr_sequence(n: int = N):
    """One more window beside the ten: a REAL lane matrix (H x H on two
    column qubits) behind a row-bit X — a standalone "lowr" step, which
    none of the ten keeps after step merging."""
    hh = np.kron(gates.H, gates.H)
    return (
        "lowr_real",
        [
            make_matrix_op([n - 1, n - 2], hh.reshape(-1)),
            make_matrix_op([0], gates.X.reshape(-1)),
        ],
        {"low", "mix"},
    )


def real_orthogonal(seed: int) -> np.ndarray:
    """A seeded real 128 x 128 orthogonal matrix (QR of a Gaussian)."""
    r = np.random.default_rng(seed)
    return np.linalg.qr(r.normal(size=(128, 128)))[0]


def step_windows(n: int = N):
    """[(name, window qubits, kernel steps, expected step kinds)]: six
    windows built directly as kernel steps, one per shape of the two step
    families the kernel treats specially — the tensor-core matrix steps
    and the separable diag — so that each shape is held against the JAX
    package's kernel (interpret mode, on the CPU) and against the plain
    version (on the card) whatever the planner would merge."""
    lane = [n - 7 + k for k in range(7)]  # lane qubits, high to low
    B1, B2 = rand_u(7, 61), rand_u(7, 62)
    fan = tuple(((3,), (lane[k],), np.pi / (2 << k)) for k in range(7))
    return [
        # complex B at h = 0: the c64_low_matmul shape (Karatsuba)
        ("low_complex_h0", (), [("low", B1)], {"low"}),
        # real B at h = 4: one GEMM over 16 strips x 8 rows
        ("lowr_h4", (0, 1, 2, 3), [("low", real_orthogonal(63))], {"lowr"}),
        # complex and real matrix blocks, a shared operand, scalar blocks
        ("rmix_complex", (0, 2), [("rmix", {
            (0, 0): ("mat", B1), (0, 1): ("scalar", 0.3 - 0.2j),
            (1, 0): ("mat", real_orthogonal(64)), (1, 1): ("mat", B2),
            (2, 2): ("scalar", 0.5), (2, 3): ("mat", B1),
            (3, 2): ("mat", B2), (3, 3): ("scalar", -0.4j),
        })], {"rmix"}),
        # a QFT controlled-phase fan: one row-support group over 7 lanes,
        # plus a window-bit CP that folds into a lane monomial on strip 1
        ("diag_cp_fan", (1,), [("diag", (
            0.0, (), (), fan + (((1,), (lane[6],), 0.6),),
        ))], {"diag"}),
        # six row-support groups: the angle-accumulation regime
        ("diag_many_groups", (0,), [("diag", (
            0.15, (((1,), 0.4),), (),
            tuple(((t,), (lane[t % 7],), 0.2 + 0.2 * t) for t in range(2, 8)),
        ))], {"diag"}),
        # constant, row, lane and mixed monomials together (two groups)
        ("diag_row_lane_mixed", (1, 4), [("diag", (
            0.25,
            (((3,), 0.3), ((1, 5), 0.7)),
            (((lane[1],), 0.2), ((lane[5], lane[6]), -0.5)),
            (((2,), (lane[2],), 0.9), ((2,), (lane[3], lane[4]), 0.35),
             ((1,), (lane[4], lane[5]), -0.4), ((5, 6), (lane[0],), 1.3)),
        ))], {"diag"}),
    ]
