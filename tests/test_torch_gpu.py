"""The port's window kernel on a CUDA device against its plain torch
version (parity and step windows, ``c64_low_matmul``, a QFT through the
builder against the CPU). The row-swap and copy kernels, the oracle ops and
``measure_prob_fn`` on the card are in ``test_torch_gpu_ops.py``, this
slice's modules in ``test_torch_gpu_interchange.py``. Every test in these
files is marked ``gpu`` and skips without a card. They import no JAX, so
they also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu*.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from rustqip_tpu_torch.engine import cuda_build
from rustqip_tpu_torch.engine import window_kernel as wk
from rustqip_tpu_torch.engine.admission import HopperSmemAdmission, window_seg_sizes
from rustqip_tpu_torch.engine.parity_windows import (
    build_sequences,
    lowr_sequence,
    rand_u,
    step_windows,
)
from rustqip_tpu_torch.engine.real_apply import compile_sweeps
from rustqip_tpu_torch.interop import planes_from_numpy, planes_to_numpy

TOL = 1e-6
PARITY = build_sequences(20) + [lowr_sequence(20)]
STEP_WINDOWS = step_windows(20)

pytestmark = pytest.mark.gpu

torch.set_num_threads(1)  # the test runner keeps one worker per core busy


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's Hopper kernels")
    return torch.device("cuda")


def _state(n, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return v / np.linalg.norm(v)


@pytest.mark.parametrize("idx", range(len(PARITY)), ids=[s[0] for s in PARITY])
def test_kernel_matches_plain_on_parity_windows(cuda, idx):
    name, ops, _ = PARITY[idx]
    n = 20
    x = planes_from_numpy(_state(n), device=cuda)
    before = cuda_build.LAUNCHES["window_sweep"]
    sweeps = compile_sweeps(n, ops, True, HopperSmemAdmission(), cuda)
    for kind, (seg, ksteps, prog), _ in sweeps:
        assert kind == "kwindow"
        a = (x[0].clone(), x[1].clone())
        b = (x[0].clone(), x[1].clone())
        wk.window_sweep(n, *a, seg, ksteps, prog=prog)
        wk.window_sweep_reference(n, *b, seg, ksteps, prog=prog)
        torch.cuda.synchronize()
        assert (a[0] - b[0]).abs().max().item() <= TOL
        assert (a[1] - b[1]).abs().max().item() <= TOL
    assert cuda_build.LAUNCHES["window_sweep"] == before + len(sweeps)


@pytest.mark.parametrize("idx", range(len(STEP_WINDOWS)), ids=[w[0] for w in STEP_WINDOWS])
def test_kernel_matches_plain_on_step_windows(cuda, idx):
    """Tensor-core matrix steps (3xTF32) and separable diag against the
    plain version, n=20, 1e-6 max abs."""
    name, hq, ksteps, kinds = STEP_WINDOWS[idx]
    n = 20
    seg = window_seg_sizes(n, hq)
    prog = wk.encode_window(n, seg, ksteps)
    assert set(prog.kinds) == kinds
    x = planes_from_numpy(_state(n, 1), device=cuda)
    a = (x[0].clone(), x[1].clone())
    b = (x[0].clone(), x[1].clone())
    wk.window_sweep(n, *a, seg, ksteps, prog=prog)
    wk.window_sweep_reference(n, *b, seg, ksteps, prog=prog)
    torch.cuda.synchronize()
    assert (a[0] - b[0]).abs().max().item() <= TOL
    assert (a[1] - b[1]).abs().max().item() <= TOL


def test_circuit_on_cuda_matches_cpu(cuda):
    """QFT-14 f32 through LocalBuilder: CUDA (kernel windows) vs CPU
    (plain torch paths)."""
    from rustqip_tpu_torch.algos import qfft
    from rustqip_tpu_torch.prelude import LocalBuilder

    states = []
    for device in (cuda, "cpu"):
        b = LocalBuilder(dtype="f32", device=device)
        r = b.register(14)
        qfft(b, r)
        if device is cuda:
            assert b.compile().sweep_counts()["kwindow"] > 0
        states.append(b.calculate_state_with_init([(r, 0b1011)], seed=0)[0])
    assert np.abs(states[0] - states[1]).max() <= 1e-5


def test_c64_low_matmul_on_cuda_is_functional(cuda):
    v = _state(12, 4)
    xr, xi = planes_from_numpy(v, device=cuda)
    xr0, xi0 = xr.clone(), xi.clone()
    B = rand_u(7, 10)
    yr, yi = wk.c64_low_matmul(xr, xi, B)
    torch.cuda.synchronize()
    assert torch.equal(xr, xr0) and torch.equal(xi, xi0)
    want = (v.reshape(-1, 128) @ B.T).reshape(-1)
    assert np.abs(planes_to_numpy(yr, yi) - want).max() <= TOL


def test_kernel_refuses_an_rbf_partner_outside_the_tile(cuda):
    n = 14
    seg = (1 << (n - 7),)
    ksteps = [("rbf", 6, tuple(complex(v) for v in rand_u(1, 3).reshape(-1)))]
    prog = wk.encode_window(n, seg, ksteps)
    prog.bt = 64  # a tile too small for the bit-6 partner
    x = planes_from_numpy(_state(n), device=cuda)
    with pytest.raises(ValueError, match="tile"):
        wk.window_sweep(n, *x, seg, ksteps, prog=prog)


def _register_windows(n):
    """(name, hq, kernel steps) of windows whose steps are all strip-local:
    they take the register-streaming path. Mixes by their nonzeros (dense,
    H on one window bit, a permutation with phases, a controlled mix that
    leaves half the strips alone), QFT's mix + diag chain, a controlled
    cmix and the step windows' diags."""
    rng = np.random.default_rng(20)
    H = np.array([[1, 1], [1, -1]]) / np.sqrt(2)

    def blocks(m):
        return {(j, i): complex(m[j, i]) for j in range(m.shape[0])
                for i in range(m.shape[1]) if m[j, i] != 0}

    perm = np.zeros((16, 16), dtype=complex)
    perm[np.arange(16), rng.permutation(16)] = np.exp(1j * rng.uniform(0, 6.3, 16))
    ctl = np.eye(16, dtype=complex)
    ctl[8:, 8:] = rand_u(3, 21)
    top = (0, 1, 2, 3)
    qft_diag = ("diag", (0.1, (((4,), 0.7), ((5, 6), -0.3)), (((14,), 0.2),), ()))
    wins = [
        ("mix_dense", top, [("mix", blocks(rand_u(4, 22)))]),
        ("mix_kron_h4", (2, 4, 6, 8), [("mix", blocks(np.kron(np.kron(H, H), np.kron(H, H))))]),
        ("mix_permutation", top, [("mix", blocks(perm))]),
        ("mix_controlled", (1, 3, 5, 7), [("mix", blocks(ctl))]),
        ("mix_h_then_diag", top, [("mix", blocks(np.kron(H, np.eye(8)))), qft_diag,
                                  ("mix", blocks(np.kron(np.eye(2), np.kron(H, np.eye(4))))),
                                  qft_diag]),
        ("cmix_controlled", (0, 2), [("cmix", 1, tuple(complex(v) for v in rand_u(1, 23).reshape(-1)),
                                      (("r", 5), ("c", 2)))]),
    ]
    wins += [(name, hq, ks) for name, hq, ks, kinds in step_windows(n)
             if kinds <= wk.STREAM_KINDS]
    return wins


REGISTER_WINDOWS = _register_windows(20)


@pytest.mark.parametrize("idx", range(len(REGISTER_WINDOWS)),
                         ids=[w[0] for w in REGISTER_WINDOWS])
def test_register_path_matches_plain(cuda, idx):
    """The register-streaming path against the plain version at n = 20 on
    a seeded state (1e-6 max abs), against the tile path on the same window,
    and every strip it does not write left bit for bit as the plain version
    leaves it."""
    name, hq, ksteps = REGISTER_WINDOWS[idx]
    n = 20
    seg = window_seg_sizes(n, hq)
    prog = wk.encode_window(n, seg, ksteps)
    assert prog.path == "registers"
    x = planes_from_numpy(_state(n, 7), device=cuda)
    a = (x[0].clone(), x[1].clone())
    b = (x[0].clone(), x[1].clone())
    t = (x[0].clone(), x[1].clone())
    before = cuda_build.LAUNCHES["window_stream"]
    wk.window_sweep(n, *a, seg, ksteps, prog=prog)
    wk.window_sweep(n, *t, seg, ksteps, prog=dataclasses.replace(prog, path="tile"))
    wk.window_sweep_reference(n, *b, seg, ksteps, prog=prog)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["window_stream"] == before + 1
    for k in range(2):
        assert (a[k] - b[k]).abs().max().item() <= TOL
        assert (a[k] - t[k]).abs().max().item() <= TOL
    for i, (sa, sb) in enumerate(zip(wk._strip_views(prog, a[0]), wk._strip_views(prog, b[0]))):
        if not prog.out_mask >> i & 1:
            assert torch.equal(sa, sb)
            assert torch.equal(wk._strip_views(prog, a[1])[i], wk._strip_views(prog, b[1])[i])
