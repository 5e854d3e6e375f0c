"""The window kernel's tile path (``csrc/window_sweep.cu``: wgmma matrix
steps, several tiles to a CTA, bulk loads) on a CUDA device against its
plain torch version, on every window of ``parity_windows.tile_windows`` at
n = 20: 1e-6 max abs on a normalized float32 state (the kernel's 3xTF32
against the plain version's float32 matmuls). Windows with several tiles
to a CTA or 8-row tiles also run from their input into fresh planes
(``out=``), which must equal the in-place result bit for bit and leave the
input bit-equal; ``c64_low_matmul`` leaves its input bit-equal; strips a
window does not write keep their bits; an rmix of 16 complex matrices
stays within 4x the plain float32 version's error against float64. Every
test is marked ``gpu`` and skips without a card; the file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu_tile.py -q
"""

import functools

import numpy as np
import pytest
import torch

from rustqip_tpu_torch.engine import cuda_build
from rustqip_tpu_torch.engine import window_kernel as wk
from rustqip_tpu_torch.engine.admission import window_seg_sizes
from rustqip_tpu_torch.engine.parity_windows import rand_u, tile_windows
from rustqip_tpu_torch.interop import planes_from_numpy
from rustqip_tpu_torch.prelude import LocalBuilder

N = 20
TOL = 1e-6
NAMES = ("lane_ladder_h0", "lowr_h0", "lane_window_h2_bt8", "rmix_h2_bt8",
         "cbf_low_lane_bits_h1", "mix_one_strip_in_h1", "h3_cmix_rbf_lowr",
         "h4_table_mix_rbf_low")
# the windows with several tiles to a block or 8-row tiles at n = 20
GROUPED = ("lane_window_h2_bt8", "rmix_h2_bt8", "cbf_low_lane_bits_h1",
           "mix_one_strip_in_h1", "h4_table_mix_rbf_low")

pytestmark = pytest.mark.gpu

torch.set_num_threads(1)  # the test runner keeps one worker per core busy


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's Hopper kernels")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _windows():
    """{name: window} of ``tile_windows(N)``, made once, when a test runs."""
    return {w[0]: w for w in tile_windows(N)}


def _planes(cuda, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=1 << N) + 1j * rng.normal(size=1 << N)
    return planes_from_numpy(v / np.linalg.norm(v), device=cuda)


def _run(name_hq_steps, x, out=None):
    _, hq, ksteps, _ = name_hq_steps
    seg = window_seg_sizes(N, hq)
    prog = wk.encode_window(N, seg, ksteps)
    return prog, wk.window_sweep(N, *x, seg, ksteps, prog=prog, out=out)


@pytest.mark.parametrize("name", NAMES)
def test_tile_window_matches_plain(cuda, name):
    """One launch of the tile path per window, within 1e-6 of the plain
    version; the kinds it reports are the window's."""
    assert set(_windows()) == set(NAMES)
    _, hq, ksteps, kinds = _windows()[name]
    x = _planes(cuda, NAMES.index(name))
    a = (x[0].clone(), x[1].clone())
    b = (x[0].clone(), x[1].clone())
    before = cuda_build.LAUNCHES["window_sweep"]
    prog, _ = _run(_windows()[name], a)
    assert prog.path == "tile" and set(prog.kinds) == kinds
    wk.window_sweep_reference(N, *b, window_seg_sizes(N, hq), ksteps, prog=prog)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["window_sweep"] == before + 1
    assert (a[0] - b[0]).abs().max().item() <= TOL
    assert (a[1] - b[1]).abs().max().item() <= TOL


@pytest.mark.parametrize("name", GROUPED)
def test_grouped_windows_into_fresh_planes(cuda, name):
    """Several tiles to a CTA, or 8-row tiles: read from the input, written
    to fresh planes, the result equals the in-place run bit for bit and the
    input keeps its bits (a window that leaves strips alone is run in
    place, and those strips keep theirs)."""
    x = _planes(cuda, 40 + GROUPED.index(name))
    keep = (x[0].clone(), x[1].clone())
    a = (x[0].clone(), x[1].clone())
    prog, _ = _run(_windows()[name], a)
    assert prog.group > 1 or prog.bt == 8
    full = prog.out_mask == (1 << (1 << prog.h)) - 1
    if full:
        out = (torch.empty_like(x[0]), torch.empty_like(x[1]))
        _run(_windows()[name], x, out=out)
        torch.cuda.synchronize()
        assert torch.equal(x[0], keep[0]) and torch.equal(x[1], keep[1])
        assert torch.equal(out[0], a[0]) and torch.equal(out[1], a[1])
    else:
        torch.cuda.synchronize()
        for plane, k in zip(a, keep):
            for i, (p, q) in enumerate(zip(wk._strip_views(prog, plane), wk._strip_views(prog, k))):
                if not prog.out_mask >> i & 1:
                    assert torch.equal(p, q)


def test_c64_low_matmul_leaves_its_input(cuda):
    """The lane matmul reads its planes and writes fresh ones: the input is
    bit-equal afterwards and the result within 1e-6 of plain matmuls."""
    x = _planes(cuda, 60)
    keep = (x[0].clone(), x[1].clone())
    B = rand_u(7, 61)
    before = cuda_build.LAUNCHES["window_sweep"]
    yr, yi = wk.c64_low_matmul(*x, B)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["window_sweep"] == before + 1
    assert yr.data_ptr() != x[0].data_ptr()
    assert torch.equal(x[0], keep[0]) and torch.equal(x[1], keep[1])
    pr, pi = wk.c64_low_matmul(*x, B, kernel=False)
    assert (yr - pr).abs().max().item() <= TOL
    assert (yi - pi).abs().max().item() <= TOL


def test_untouched_strips_keep_their_bits(cuda):
    """Butterflies controlled on a window bit write only the strips where
    that bit is 1; the others keep their bits, and the written ones are
    within 1e-6 of the plain version."""
    hq = (N - 7 - 1 - 3,)  # the window bit is row bit 3
    seg = window_seg_sizes(N, hq)
    ksteps = [("cbf", 1, tuple(complex(v) for v in rand_u(1, 62).reshape(-1)), (("r", 3),)),
              ("rbf", 2, (0.6, 0.8, 0.8, -0.6), (("r", 3),))]
    prog = wk.encode_window(N, seg, ksteps)
    assert prog.out_mask == 0b10 and prog.path == "tile"
    x = _planes(cuda, 63)
    a = (x[0].clone(), x[1].clone())
    b = (x[0].clone(), x[1].clone())
    wk.window_sweep(N, *a, seg, ksteps, prog=prog)
    wk.window_sweep_reference(N, *b, seg, ksteps, prog=prog)
    torch.cuda.synchronize()
    for got, want, orig in zip(a, b, x):
        assert (got - want).abs().max().item() <= TOL
        assert torch.equal(wk._strip_views(prog, got)[0], wk._strip_views(prog, orig)[0])


def rmix16_circuit(b, n):
    """A dense random 4-qubit gate on the two top row qubits and the two
    top lane qubits: one tile-path window of one rmix step of 16 distinct
    complex matrices (4 x 4 blocks of 128 x 128) under the H100's
    admission."""
    qs = [b.qubit() for _ in range(n)]
    b.apply_matrix(b.merge_registers([qs[0], qs[1], qs[n - 2], qs[n - 1]]), rand_u(4, 5))


def test_rmix_of_many_matrices_keeps_float32_precision(cuda):
    """Each matrix of an rmix step accumulates from zero on the tensor
    cores and the products are summed by rounded float adds: the kernel's
    error against the window in float64 stays within 4x the plain float32
    version's. (The tensor cores' accumulation does not round to nearest:
    one accumulator through all 16 GEMMs lost precision with each.)"""
    b = LocalBuilder(dtype="f32", device="cuda", kernel_ok=True)
    rmix16_circuit(b, N)
    ((kind, (seg, ksteps, prog), _),) = [s for seg in b.compile().sweeps for s in seg]
    assert kind == "kwindow" and prog.path == "tile" and prog.kinds == ("rmix",)
    assert prog.nchunks == 16 * 8
    x = _planes(cuda, 77)
    k = wk.window_sweep(N, x[0].clone(), x[1].clone(), seg, ksteps, prog=prog)
    d = wk.window_sweep_reference(N, x[0].double(), x[1].double(), seg, ksteps, prog=prog)
    f = wk.window_sweep_reference(N, x[0].clone(), x[1].clone(), seg, ksteps, prog=prog)
    torch.cuda.synchronize()

    def err(y):
        return max((y[0].double() - d[0]).abs().max().item(),
                   (y[1].double() - d[1]).abs().max().item())

    assert 0 < err(k) <= 4 * err(f)
