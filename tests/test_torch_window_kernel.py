"""The window kernel's plain torch version against the JAX package's Pallas
kernel in interpret mode (n=16, one window per step kind, the same kernel
steps fed to both), the diag encoding, the wrapper's CPU contract and the
encoded program. The kernel path on the parity windows is in
``test_torch_window_parity.py``. Tolerance: 1e-6 max abs on normalized f32
states (``scripts/kernel_parity.py``). The CUDA kernel itself is checked
against the plain version by ``test_torch_gpu.py``, which skips without a
card, and by ``chip_smoke.py``."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rustqip_tpu.engine import pallas_kernels as ref_pk  # noqa: E402
from rustqip_tpu.engine import real_apply as ref_ra  # noqa: E402

from rustqip_tpu_torch.engine import cuda_build  # noqa: E402
from rustqip_tpu_torch.engine import window_kernel as wk  # noqa: E402
from rustqip_tpu_torch.engine.admission import (  # noqa: E402
    HopperSmemAdmission,
    window_seg_sizes,
)
from rustqip_tpu_torch.engine.parity_windows import rand_u, step_windows  # noqa: E402
from rustqip_tpu_torch.interop import planes_from_numpy, planes_to_numpy  # noqa: E402

torch.set_num_threads(1)  # the test runner keeps one worker per core busy

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
    pr, pi = planes_from_numpy(v, device="cpu")
    out = wk.window_sweep_reference(n, pr, pi, seg, ksteps, prog=prog)
    assert out[0] is pr and out[1] is pi  # in place
    got = planes_to_numpy(pr, pi)
    assert np.abs(got - want).max() <= TOL
    # amplitudes the reference leaves alone stay bit-identical in place
    v32 = v.astype(np.complex64).astype(np.complex128)
    kept = want == v32
    assert np.array_equal(got[kept], v32[kept])


STEP_WINDOWS = {w[0]: w for w in step_windows(N)}


@pytest.mark.parametrize("name", sorted(STEP_WINDOWS))
def test_step_window_matches_reference_interpret(name):
    """The matrix-step and diag shapes the kernel treats specially: the
    plain version of the encoded program against the JAX package's kernel
    in interpret mode (f32, 1e-6 max abs on a normalized state)."""
    _, hq, ksteps, kinds = STEP_WINDOWS[name]
    n = N
    seg = window_seg_sizes(n, hq)
    v = _state(n, 5)
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
    assert set(prog.kinds) == kinds
    pr, pi = planes_from_numpy(v, device="cpu")
    wk.window_sweep_reference(n, pr, pi, seg, ksteps, prog=prog)
    assert np.abs(planes_to_numpy(pr, pi) - want).max() <= TOL


def _diag_entries(prog):
    """Per-strip diag entries of a one-diag-step program."""
    rec = prog.iprog[:8]
    assert wk.KINDS[rec[0]] == "diag"
    ns = 1 << prog.h
    out = {}
    for i in range(ns):
        if rec[1] >> i & 1:
            out[i] = tuple(int(x) for x in prog.iprog[rec[2] + 6 * i : rec[2] + 6 * i + 6])
    return out


def test_diag_encoding_is_separable():
    """A diag entry holds the lane monomials as one precomputed 128-entry
    complex lane factor and the mixed monomials as one row mask + one lane
    vector per row support (a QFT fan is one group); many groups switch to
    angles."""
    n = N
    lane = [n - 7 + k for k in range(7)]
    _, hq, ksteps, _ = STEP_WINDOWS["diag_row_lane_mixed"]
    prog = wk.encode_window(n, window_seg_sizes(n, hq), ksteps)
    ents = _diag_entries(prog)
    cols = np.arange(128)

    def bits(qs):
        m = sum(1 << (n - 1 - q) for q in qs)
        return (cols & m) == m

    # strip 0b10 of window (1, 4): qubit 1 = 1, qubit 4 = 0
    io, fo, nr, G, mode, lo = ents[0b10]
    assert mode == 0 and G == 2
    row_support = [int(x) for x in prog.iprog[io + nr : io + nr + G]]
    n_m = n - 7
    assert row_support == [1 << (n_m - 1 - 2), (1 << (n_m - 1 - 5)) | (1 << (n_m - 1 - 6))]
    lane_ang = 0.2 * bits([lane[1]]) - 0.5 * bits([lane[5], lane[6]]) - 0.4 * bits([lane[4], lane[5]])
    lane_part = prog.fprog[lo : lo + 256]
    np.testing.assert_allclose(lane_part[:128], np.cos(lane_ang), atol=1e-7)
    np.testing.assert_allclose(lane_part[128:], np.sin(lane_ang), atol=1e-7)
    g0 = prog.fprog[lo + 256 : lo + 512]
    g0_ang = 0.9 * bits([lane[2]]) + 0.35 * bits([lane[3], lane[4]])
    np.testing.assert_allclose(g0[:128], np.cos(g0_ang), atol=1e-7)
    fan = STEP_WINDOWS["diag_cp_fan"]
    ents = _diag_entries(wk.encode_window(n, window_seg_sizes(n, fan[1]), fan[2]))
    assert {e[3] for e in ents.values()} == {1}
    many = STEP_WINDOWS["diag_many_groups"]
    ents = _diag_entries(wk.encode_window(n, window_seg_sizes(n, many[1]), many[2]))
    assert all(e[3] == 6 and e[4] == 1 for e in ents.values())


@pytest.mark.parametrize("name", ["diag_row_lane_mixed", "diag_cp_fan"])
def test_diag_factor_and_angle_modes_agree(name, monkeypatch):
    """The same diag through the factor encoding and, with the group limit
    at 0, through the angle encoding (1e-6 max abs)."""
    _, hq, ksteps, _ = STEP_WINDOWS[name]
    n = N
    seg = window_seg_sizes(n, hq)
    v = _state(n, 6)
    a = planes_from_numpy(v, device="cpu")
    wk.window_sweep_reference(n, *a, seg, ksteps)
    monkeypatch.setattr(wk, "DIAG_MASK_MAX", 0)
    prog = wk.encode_window(n, seg, ksteps)
    assert all(e[4] == 1 for e in _diag_entries(prog).values())
    b = planes_from_numpy(v, device="cpu")
    wk.window_sweep_reference(n, *b, seg, ksteps, prog=prog)
    assert np.abs(planes_to_numpy(*a) - planes_to_numpy(*b)).max() <= TOL


def test_matrix_operands_reach_the_kernel_as_b():
    """The plain version reads each operand as B (row c = output lane c),
    complex ones as (re, im, re + im) in float32; the rmix record lists the
    step's distinct operands once each, with a complex flag; the kernel's
    B stream holds 8 chunks per distinct operand (TF32 hi and lo of re,
    then of im for a complex one) in that order."""
    B = rand_u(7, 12)
    prog = wk.encode_window(N, (1 << (N - 7),), [("low", B)])
    np.testing.assert_array_equal(prog.mats[0], B.real.astype(np.float32))
    np.testing.assert_array_equal(prog.mats[1], B.imag.astype(np.float32))
    np.testing.assert_array_equal(
        prog.mats[2], B.real.astype(np.float32) + B.imag.astype(np.float32)
    )
    _, hq, ksteps, _ = STEP_WINDOWS["rmix_complex"]
    prog = wk.encode_window(N, window_seg_sizes(N, hq), ksteps)
    rec = prog.iprog[:8]
    mlist = prog.iprog[rec[3] : rec[3] + 2 * rec[4]].reshape(-1, 2).tolist()
    assert mlist == [[0, 1], [3, 0], [4, 1]] and rec[5] == 1
    # chunks of 16 k x 128 lanes: (re, im) x (hi, lo) for a complex
    # operand, (hi, lo) of re for a real one, staged whole
    tab = prog.iprog[prog.chunk_tab : prog.chunk_tab + 2 * prog.nchunks].reshape(-1, 2)
    assert prog.nchunks == 24
    assert tab[:, 1].tolist() == [4 * 4 * 2048] * 8 + [2 * 4 * 2048] * 8 + [4 * 4 * 2048] * 8
    assert tab[:, 0].tolist() == (np.cumsum(tab[:, 1]) - tab[:, 1]).__floordiv__(16).tolist()
    want = np.concatenate([
        wk.b_chunks(prog.mats[i], prog.mats[i + 1] if c else None).reshape(-1)
        for i, c in mlist
    ])
    np.testing.assert_array_equal(prog.bstream, want)
    assert prog.stage_bytes == 4 * 4 * 2048 and prog.nstage >= 2
    assert prog.smem_bytes <= 232448


def test_wrapper_cpu_contract():
    """On a CPU state the wrapper is the plain version and counts no
    launch; it refuses what the kernel does not take."""
    n = 14
    hq, ksteps = (0,), [("cbf", 1, _coeffs(9)), ("mix", {(0, 1): 1, (1, 0): 1j})]
    seg = window_seg_sizes(n, hq)
    v = _state(n, 3)
    a = planes_from_numpy(v, device="cpu")
    b = planes_from_numpy(v, device="cpu")
    before = dict(cuda_build.LAUNCHES)
    wk.window_sweep(n, *a, seg, ksteps)
    wk.window_sweep_reference(n, *b, seg, ksteps)
    assert dict(cuda_build.LAUNCHES) == before
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(TypeError):
        wk.window_sweep(n, *planes_from_numpy(v, dtype=torch.float64, device="cpu"), seg, ksteps)
    with pytest.raises(ValueError):
        x = planes_from_numpy(v, device="cpu")
        wk.window_sweep(n, x[0].reshape(-1), x[1].reshape(-1), seg, ksteps)
    with pytest.raises(ValueError):
        x = planes_from_numpy(_state(n + 1, 3), device="cpu")
        wk.window_sweep(n, x[0][:, ::2], x[1][:, ::2], seg, ksteps)


def test_c64_low_matmul_is_functional():
    """(xr + i xi) @ B^T, inputs untouched (a wide controlled op reads its
    input again after the inner op ran)."""
    v = _state(12, 4)
    xr, xi = planes_from_numpy(v, device="cpu")
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
    xr, xi = planes_from_numpy(v, device="cpu")
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
