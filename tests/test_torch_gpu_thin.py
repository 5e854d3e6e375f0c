"""The window kernel's register path on thin trailing row segments, on a
CUDA device at n = 20: windows that hold row qubit n - 8, n - 9 or n - 10
(a trailing segment of 1, 2 or 4 rows, under the tile path's smallest
tile), as a dense h = 2 ``mix`` and a dense h = 4 one that factor per no
window bit, each one ``window_stream`` launch within 1e-6 of the plain
version; the tile path refuses such a segment rather than launching,
while the lane matmul on a state under one tile launches its whole-state
tile; and a compiled QV-20, whose plan takes such windows under the H100's
admission, against the benchmark's plain reference. Marked ``gpu``:
skips without a card; imports no JAX (see ``test_torch_gpu.py``).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rustqip_tpu_torch.engine import cuda_build
from rustqip_tpu_torch.engine import window_kernel as wk
from rustqip_tpu_torch.engine.admission import HOPPER, thin_segment, window_seg_sizes
from rustqip_tpu_torch.engine.compile import MeasureEntry
from rustqip_tpu_torch.engine.parity_windows import rand_u
from rustqip_tpu_torch.interop import planes_from_numpy
from rustqip_tpu_torch.prelude import LocalBuilder
from rustqip_tpu_torch.utils import observe

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.circuits import qv as qv_circuit  # noqa: E402
from portbench.reference import qv  # noqa: E402

N = 20
TOL = 1e-6
#: A compiled QV-20 against the complex128 reference, in units of the rms
#: amplitude 2^-n/2 (the benchmark's ``amp_gap``): the tile path's rmix
#: windows read about twice plain float32's error.
QV_TOL = 1e-4

pytestmark = pytest.mark.gpu

torch.set_num_threads(1)  # the test runner keeps one worker per core busy


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's Hopper kernels")
    return torch.device("cuda")


def _planes(cuda, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=1 << N) + 1j * rng.normal(size=1 << N)
    return planes_from_numpy(v / np.linalg.norm(v), device=cuda)


def _dense_mix(h, seed):
    u = rand_u(h, seed)
    return ("mix", {(j, i): complex(u[j, i]) for j in range(1 << h) for i in range(1 << h)})


@pytest.mark.parametrize("h", [2, 4])
@pytest.mark.parametrize("below", [8, 9, 10])
def test_dense_mix_on_a_thin_segment(cuda, h, below):
    """A dense ``mix`` whose lowest window qubit is n - ``below``: a
    trailing segment of 2^(below - 8) rows, which the register path takes
    in one launch."""
    hq = (1, 4, 7)[: h - 1] + (N - below,)
    seg = window_seg_sizes(N, hq)
    assert seg[-1] == 1 << (below - 8) and thin_segment(seg)
    ksteps = [_dense_mix(h, 10 * h + below)]
    prog = wk.encode_window(N, seg, ksteps)
    assert prog.path == "registers" and prog.kinds == ("mix",)
    x = _planes(cuda, below + h)
    a = (x[0].clone(), x[1].clone())
    b = (x[0].clone(), x[1].clone())
    before = dict(cuda_build.LAUNCHES)
    wk.window_sweep(N, *a, seg, ksteps, prog=prog)
    wk.window_sweep_reference(N, *b, seg, ksteps, prog=prog)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["window_stream"] == before.get("window_stream", 0) + 1
    assert cuda_build.LAUNCHES["window_sweep"] == before.get("window_sweep", 0) + 1
    assert (a[0] - b[0]).abs().max().item() <= TOL
    assert (a[1] - b[1]).abs().max().item() <= TOL


def test_tile_path_refuses_a_thin_segment(cuda):
    """An rmix window on a 2-row trailing segment encodes to a tile under
    the tile path's smallest: the launch raises, and nothing is written."""
    hq = (3, N - 9)
    seg = window_seg_sizes(N, hq)
    ksteps = [("rmix", {(j, i): ("mat", rand_u(7, 70 + 4 * j + i))
                        for j in range(4) for i in range(4)})]
    prog = wk.encode_window(N, seg, ksteps)
    assert prog.path == "tile" and prog.bt < HOPPER.MIN_TILE_ROWS
    x = _planes(cuda, 71)
    keep = (x[0].clone(), x[1].clone())
    with pytest.raises(ValueError, match="tile"):
        wk.window_sweep(N, *x, seg, ksteps, prog=prog)
    assert torch.equal(x[0], keep[0]) and torch.equal(x[1], keep[1])


@pytest.mark.parametrize("n", [7, 8, 9])
def test_lane_matmul_on_a_state_under_one_tile(cuda, n):
    """``c64_low_matmul`` on a state of fewer rows than the tile path's
    smallest tile (1, 2 or 4 rows): its one-``low``-step tile holds the
    whole state, so the kernel takes it in one launch, leaves the input
    bit-equal and comes within 1e-6 of the plain matmuls."""
    rng = np.random.default_rng(72 + n)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    x = planes_from_numpy(v / np.linalg.norm(v), device=cuda)
    assert x[0].shape[0] == 1 << (n - 7) < HOPPER.MIN_TILE_ROWS
    keep = (x[0].clone(), x[1].clone())
    B = rand_u(7, 73 + n)
    before = cuda_build.LAUNCHES["window_sweep"]
    got = wk.c64_low_matmul(*x, B)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["window_sweep"] == before + 1
    assert torch.equal(x[0], keep[0]) and torch.equal(x[1], keep[1])
    want = wk.c64_low_matmul(*x, B, kernel=False)
    assert (got[0] - want[0]).abs().max().item() <= TOL
    assert (got[1] - want[1]).abs().max().item() <= TOL


def test_compiled_qv20_matches_the_reference(cuda):
    """QV-20 through ``LocalBuilder`` on the card: its plan takes register
    windows on thin segments (counted once each a run in
    ``COUNTS["window_stream_thin"]``, each one ``window_stream`` launch)
    and the state stays within ``QV_TOL`` of the complex128 reference."""
    seed = 2**31 + 20
    cfg = {"num_qubits": N, "depth": N, "pairs_seed": 1}
    b = LocalBuilder(dtype="f32", device=cuda)
    qv_circuit.build(b, cfg, {"circuit_seed": seed})
    cc = b.compile()
    kernel = [p for seg in cc.sweeps if not isinstance(seg, MeasureEntry)
              for kind, p, _ in seg if kind == "kwindow"]
    thin = sum(1 for seg, _, prog in kernel
               if prog.path == "registers" and thin_segment(seg))
    stream = sum(1 for _, _, prog in kernel if prog.path == "registers")
    assert thin > 0
    counted = observe.COUNTS["window_stream_thin"]
    launched = cuda_build.LAUNCHES["window_stream"]
    re, im, _ = cc.run(0)
    torch.cuda.synchronize()
    assert observe.COUNTS["window_stream_thin"] - counted == thin
    assert cuda_build.LAUNCHES["window_stream"] - launched == stream
    got = re.double().cpu().reshape(-1).numpy() + 1j * im.double().cpu().reshape(-1).numpy()
    want = qv.state(N, qv.circuit(cfg, {"circuit_seed": seed})).numpy()
    gap = np.abs(got - want).max() * 2.0 ** (N / 2)
    print(f"qv20 amp gap {gap:.3e}, thin register windows {thin} of {stream}")
    assert gap <= QV_TOL
