"""A QPE phase product whose moduli drift from 1 inside a kernel window, on
a CUDA device: the window that QPE-20's plan makes around it (the H100's
admission leaves out its log-magnitude, which rounds to 1 in float32) in
one launch within 1e-6 of its plain version and of the plain passes of its
ops, which apply that magnitude; and QPE-24 through ``CompiledCircuit.run``
within 1e-5 of the same circuit with the kernels off, its outcome the
closed form's, ``observe.COUNTS["diag_mag_rounded"]`` counted once a run.
Marked ``gpu``: skips without a card; imports no JAX (see
``test_torch_gpu.py``).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rustqip_tpu_torch.engine import cuda_build
from rustqip_tpu_torch.engine import window_kernel as wk
from rustqip_tpu_torch.engine.admission import HOPPER
from rustqip_tpu_torch.engine.compile import MeasureEntry
from rustqip_tpu_torch.engine.real_apply import compile_sweeps, run_sweeps
from rustqip_tpu_torch.interop import planes_from_numpy
from rustqip_tpu_torch.ops.matrix_ops import PhaseProductOp
from rustqip_tpu_torch.prelude import LocalBuilder
from rustqip_tpu_torch.utils import observe

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.circuits import qpe as qpe_circuit  # noqa: E402
from portbench.reference import qpe as qpe_reference  # noqa: E402

TOL = 1e-6
E2E_TOL = 1e-5

pytestmark = pytest.mark.gpu

torch.set_num_threads(1)  # the test runner keeps one worker per core busy


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's Hopper kernels")
    return torch.device("cuda")


def _qpe(n, j, device, kernel_ok=None):
    b = LocalBuilder(dtype="f32", device=device, kernel_ok=kernel_ok)
    cfg = {"num_qubits": n, "counting_qubits": n - 1, "target_qubits": 1,
           "phase_bits": n - 1}
    qpe_circuit.build(b, cfg, {"phase_int": j})
    return b.compile()


def _kernel_sweeps(cc):
    return [(p, run) for seg in cc.sweeps if not isinstance(seg, MeasureEntry)
            for kind, p, run in seg if kind == "kwindow"]


def test_drifted_phase_window(cuda):
    """QPE-20's window that holds its phase product: one launch, within
    1e-6 of the plain version of the same step program and of the plain
    passes of the window's ops (the phase product's magnitude applied)."""
    n = 20
    cc = _qpe(n, 2 * 77777 % (1 << (n - 1)) + 1, cuda)
    ((seg, ksteps, prog), run), = [w for w in _kernel_sweeps(cc) if w[0][2].mag_rounded]
    assert any(isinstance(op, PhaseProductOp) for op in run) and "diag" in prog.kinds
    rng = np.random.default_rng(20)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    x = planes_from_numpy(v / np.linalg.norm(v), device=cuda)
    a = (x[0].clone(), x[1].clone())
    b = (x[0].clone(), x[1].clone())
    before = cuda_build.LAUNCHES["window_sweep"]
    wk.window_sweep(n, *a, seg, ksteps, prog=prog)
    wk.window_sweep_reference(n, *b, seg, ksteps, prog=prog)
    plain = run_sweeps(n, compile_sweeps(n, run, False, HOPPER), *x,
                       low_kernel=False, swap_kernel=False)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["window_sweep"] == before + 1
    for got, want in ((a, b), (a, plain)):
        assert (got[0] - want[0]).abs().max().item() <= TOL
        assert (got[1] - want[1]).abs().max().item() <= TOL


def test_qpe24_through_the_window(cuda):
    """QPE-24 compiled on the card: its phase product rides a kernel
    window, counted once a run; each run's state within 1e-5 of the kernels
    off, and its collapse the closed form's outcome at probability 1."""
    n, j = 24, 2 * 3000001 + 1
    cc = _qpe(n, j, cuda)
    plain = _qpe(n, j, cuda, kernel_ok=False)
    assert sum(p[2].mag_rounded for p, _ in _kernel_sweeps(cc)) == 1
    assert not plain._kernel_ok
    for seed in (1, 2):
        gen = torch.Generator()
        gen.manual_seed(seed)
        counted = observe.COUNTS["diag_mag_rounded"]
        re, im, res = cc.run(0, generator=gen)
        torch.cuda.synchronize()
        assert observe.COUNTS["diag_mag_rounded"] == counted + 1
        gen.manual_seed(seed)
        pre, pim, pres = plain.run(0, generator=gen)
        assert (re - pre).abs().max().item() <= E2E_TOL
        assert (im - pim).abs().max().item() <= E2E_TOL
        (outcome, prob), = [r for r in res if isinstance(r, tuple)]
        assert qpe_reference.flip(n - 1, outcome) == j
        assert abs(float(prob) - 1.0) <= E2E_TOL
        assert [r for r in pres if isinstance(r, tuple)][0][0] == outcome
