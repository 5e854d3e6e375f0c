"""The window kernel's plain torch version against the JAX package's Pallas
kernel in interpret mode (n=16, one window per step kind, the same kernel
steps fed to both), and the port's kernel path against the JAX package's
per-op engine on the ten parity windows (n=20). Tolerance: 1e-6 max abs on
normalized f32 states (``scripts/kernel_parity.py``). The CUDA kernel
itself is checked against the plain version by ``test_torch_gpu.py``,
which skips without a card, and by ``chip_smoke.py``."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rustqip_tpu.engine import pallas_kernels as ref_pk  # noqa: E402
from rustqip_tpu.engine import real_apply as ref_ra  # noqa: E402

from rustqip_tpu_torch.engine import window_kernel as wk  # noqa: E402
from rustqip_tpu_torch.engine.admission import (  # noqa: E402
    HopperSmemAdmission,
    TpuReferenceAdmission,
    window_seg_sizes,
)
from rustqip_tpu_torch.engine.parity_windows import (  # noqa: E402
    build_sequences,
    lowr_sequence,
    rand_u,
)
from rustqip_tpu_torch.engine.real_apply import (  # noqa: E402
    apply_ops_ri,
    compile_sweeps,
)
from rustqip_tpu_torch.interop import planes_from_numpy, planes_to_numpy  # noqa: E402

N = 16  # row qubits 0..8 (row bits 8..0), lane qubits 9..15
TOL = 1e-6


def _state(n, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return v / np.linalg.norm(v)


def _coeffs(seed):
    return tuple(complex(v) for v in rand_u(1, seed).reshape(-1))


def _windows():
    """Hand-built (hq, kernel steps) windows, one per step kind."""
    u4 = rand_u(2, 3)
    mix = {(j, i): complex(u4[j, i]) for j in range(4) for i in range(4)}
    B = rand_u(7, 4)
    Br = np.linalg.qr(np.random.default_rng(5).normal(size=(128, 128)))[0]
    groups = (
        0.25,
        (((3,), 0.3), ((1, 4), 0.7)),
        (((10,), 0.2),),
        (((2,), (12,), 0.9), ((1,), (13, 14), -0.4), ((5, 6), (9,), 1.3)),
    )
    return {
        "mix": ((0, 2), [("mix", mix)]),
        "rmix": ((0,), [("rmix", {
            (0, 0): ("mat", B), (0, 1): ("scalar", 0.5j),
            (1, 0): ("mat", Br), (1, 1): ("scalar", -0.75),
        })]),
        "diag": ((1,), [("diag", groups)]),
        "cbf": ((0,), [("cbf", 3, _coeffs(6), (("r", 8), ("c", 0)))]),
        "rbf": ((), [("rbf", 2, _coeffs(7), (("c", 5), ("r", 6)))]),
        "cmix": ((1,), [("cmix", 0, _coeffs(8), (("r", 4), ("c", 1)))]),
        "low": ((), [("low", B)]),
        "lowr": ((2,), [("low", Br), ("mix", {(0, 1): 1, (1, 0): 1})]),
    }


WINDOWS = _windows()


@pytest.mark.parametrize("kind", sorted(WINDOWS))
def test_plain_window_matches_reference_interpret(kind):
    hq, ksteps = WINDOWS[kind]
    n = N
    seg = window_seg_sizes(n, hq)
    assert tuple(seg) == tuple(ref_ra._window_seg_sizes(n, hq))
    v = _state(n, 1)
    R = 1 << (n - 7)
    er, ei = ref_pk.window_sweep(
        n,
        jnp.asarray(v.real.astype(np.float32).reshape(R, 128)),
        jnp.asarray(v.imag.astype(np.float32).reshape(R, 128)),
        seg, ksteps, interpret=True,
    )
    want = np.asarray(er, np.float64).reshape(-1) + 1j * np.asarray(
        ei, np.float64
    ).reshape(-1)
    prog = wk.encode_window(n, seg, ksteps)
    assert kind in prog.kinds
    pr, pi = planes_from_numpy(v)
    out = wk.window_sweep_reference(n, pr, pi, seg, ksteps, prog=prog)
    assert out[0] is pr and out[1] is pi  # in place
    got = planes_to_numpy(pr, pi)
    assert np.abs(got - want).max() <= TOL
    # amplitudes the reference leaves alone stay bit-identical in place
    v32 = v.astype(np.complex64).astype(np.complex128)
    kept = want == v32
    assert np.array_equal(got[kept], v32[kept])


PARITY = build_sequences(20) + [lowr_sequence(20)]


@pytest.mark.parametrize("idx", range(len(PARITY)), ids=[s[0] for s in PARITY])
def test_parity_window_kernel_path_matches_reference_engine(idx):
    """The port's kernel path (kwindows through the plain version on the
    CPU) against the JAX package's per-op engine, at n=20."""
    name, ops, expected = PARITY[idx]
    n = 20
    ref_ops = _to_reference(ops)
    v = _state(n, 2)
    er = jnp.asarray(v.real)
    ei = jnp.asarray(v.imag)
    for op in ref_ops:
        er, ei = ref_ra.apply_op_ri(n, op, er, ei)
    want = np.asarray(er) + 1j * np.asarray(ei)
    sweeps = compile_sweeps(n, ops, True, TpuReferenceAdmission())
    assert all(k == "kwindow" for k, _, _ in sweeps), name
    pr, pi = planes_from_numpy(v)
    gr, gi = apply_ops_ri(n, ops, pr, pi, kernel_ok=True,
                          admission=TpuReferenceAdmission())
    assert np.abs(planes_to_numpy(gr, gi) - want).max() <= TOL


def _to_reference(ops):
    """Port ops -> the JAX package's ops (the parity windows only use
    dense, control and phase-product ops)."""
    from rustqip_tpu.ops import matrix_ops as R

    out = []
    for op in ops:
        kind = type(op).__name__
        if kind == "DenseOp":
            out.append(R.make_matrix_op(op.indices, op.data.reshape(-1)))
        elif kind == "ControlOp":
            inner = _to_reference([op.inner])[0]
            out.append(R.make_control_op(op.control_indices, inner))
        elif kind == "PhaseProductOp":
            out.append(R.PhaseProductOp(op.terms))
        else:
            raise TypeError(kind)
    return out


def test_wrapper_cpu_contract():
    """On a CPU state the wrapper is the plain version and counts no
    launch; it refuses what the kernel does not take."""
    n = 14
    hq, ksteps = (0,), [("cbf", 1, _coeffs(9)), ("mix", {(0, 1): 1, (1, 0): 1j})]
    seg = window_seg_sizes(n, hq)
    v = _state(n, 3)
    a = planes_from_numpy(v)
    b = planes_from_numpy(v)
    before = dict(wk.LAUNCHES)
    wk.window_sweep(n, *a, seg, ksteps)
    wk.window_sweep_reference(n, *b, seg, ksteps)
    assert dict(wk.LAUNCHES) == before
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(TypeError):
        wk.window_sweep(n, *planes_from_numpy(v, dtype=torch.float64), seg, ksteps)
    with pytest.raises(ValueError):
        x = planes_from_numpy(v)
        wk.window_sweep(n, x[0].reshape(-1), x[1].reshape(-1), seg, ksteps)
    with pytest.raises(ValueError):
        x = planes_from_numpy(_state(n + 1, 3))
        wk.window_sweep(n, x[0][:, ::2], x[1][:, ::2], seg, ksteps)


def test_c64_low_matmul_is_functional():
    """(xr + i xi) @ B^T, inputs untouched (a wide controlled op reads its
    input again after the inner op ran)."""
    v = _state(12, 4)
    xr, xi = planes_from_numpy(v)
    xr0, xi0 = xr.clone(), xi.clone()
    B = rand_u(7, 10)
    yr, yi = wk.c64_low_matmul(xr, xi, B)
    assert torch.equal(xr, xr0) and torch.equal(xi, xi0)
    want = (v.reshape(-1, 128) @ B.T).reshape(-1)
    assert np.abs(planes_to_numpy(yr, yi) - want).max() <= TOL


def test_low_program_is_encoded_once_per_matrix():
    """c64_low_matmul's one-low-step window program is encoded once per
    (rows, matrix), not per call, and computes x @ B^T."""
    B = rand_u(7, 10)
    R = 1 << 5
    prog = wk._low_program(R, B)
    assert wk._low_program(R, B.copy()) is prog
    assert wk._low_program(R, rand_u(7, 11)) is not prog
    assert wk._low_program(2 * R, B) is not prog
    v = _state(12, 4)
    xr, xi = planes_from_numpy(v)
    wk.window_sweep(prog.n, xr, xi, prog.seg_sizes, [("low", B)], prog=prog)
    want = (v.reshape(-1, 128) @ B.T).reshape(-1)
    assert np.abs(planes_to_numpy(xr, xi) - want).max() <= TOL


def test_encoded_program_layout():
    """Records, masks and tile rows of an encoded window."""
    hq, ksteps = WINDOWS["cmix"]
    seg = window_seg_sizes(N, hq)
    prog = wk.encode_window(N, seg, ksteps)
    assert prog.nsteps == 1 and prog.h == 1
    rec = prog.iprog[:8]
    assert wk.KINDS[rec[0]] == "cmix" and rec[1] == 0b01 and rec[2] == 0
    assert rec[3] == 1 << 4 and rec[4] == 1 << 1
    assert prog.in_mask == prog.out_mask == 0b11
    assert prog.bt == min(64, seg[-1])
    assert HopperSmemAdmission().block_rows(1, ksteps, seg[-1]) == prog.bt


@pytest.mark.parametrize("hq", [(), (0,), (1, 4), (0, 2, 3), (2, 3, 5, 6)])
def test_strip_addressing_matches_reference(hq):
    """The CUDA kernel finds each CTA's rows by the formula of the ported
    ``_strip_index_map`` (the same as the reference's); the plain version
    takes the strips as reshape views. Both must name the same rows."""
    n = 16
    seg = tuple(window_seg_sizes(n, hq))
    prog = wk.encode_window(n, seg, [("low", np.eye(128))])
    bt = prog.bt
    sl = seg[-1] // bt
    rows = wk._strip_rows(prog, "cpu")
    for i in range(1 << len(hq)):
        port_map = wk._strip_index_map(seg, sl, i)
        ref_map = ref_pk._strip_index_map(seg, sl, i)
        for r in range(len(rows[i]) // bt):
            assert port_map(r) == ref_map(r)
            start = port_map(r)[0] * bt
            assert rows[i][r * bt : (r + 1) * bt].tolist() == list(
                range(start, start + bt)
            )
