"""The monomial pass on a CUDA device (``engine/monomial.py``,
``csrc/monomial_pass.cu``): the kernel bit-equal to its plain version on
Shor's controlled modular multiplications at n = 24 (the work register on
the 7 lanes and 3 row bits, the control anywhere above), and within 2^-23
relative on random monomial ops with phases whose targets lie on lanes,
on rows or on both, under 0 to 3 controls; in place and on copies. Shor at
n = 24 through ``CompiledCircuit.run``: one launch a multiplication, its
distribution the plain reference's, and no monomial pass raises the
allocator's peak by more than one block of scratch (``types.PASS_BLOCK``
elements a plane) over the state; with the kernels off the run takes the
plain pass and launches no permutation kernel. Marked ``gpu``: skips
without a card;
imports no JAX (see ``test_torch_gpu.py``).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rustqip_tpu_torch import types as port_types
from rustqip_tpu_torch.algos.shor import _mod_mult_permutation
from rustqip_tpu_torch.engine import cuda_build, monomial
from rustqip_tpu_torch.engine.compile import MeasureEntry
from rustqip_tpu_torch.engine.real_apply import run_sweeps
from rustqip_tpu_torch.ops.matrix_ops import DenseOp, make_control_op
from rustqip_tpu_torch.ops.measurement_ops import measure_probs_ri
from rustqip_tpu_torch.prelude import LocalBuilder
from rustqip_tpu_torch.types import geometry
from rustqip_tpu_torch.utils import observe

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.circuits import shor as shor_circuit  # noqa: E402
from portbench.reference import shor as shor_reference  # noqa: E402

pytestmark = pytest.mark.gpu

torch.set_num_threads(1)  # the test runner keeps one worker per core busy

N = 24
T = 14  # counting qubits of Shor at n = 24 with N = 1007's 10 work qubits


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's Hopper kernels")
    return torch.device("cuda")


def _planes(n, device, seed):
    _, R, C = geometry(n)
    gen = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn((R, C), generator=gen, device=device),
            torch.randn((R, C), generator=gen, device=device))


def _both(n, op, device, seed=0):
    """(kernel planes, plain planes, input) of ``op``'s pass on one input."""
    plan = monomial.plan_of(n, op)
    assert plan is not None
    xr, xi = _planes(n, device, seed)
    before = cuda_build.LAUNCHES["monomial_pass"]
    kr, ki = monomial.monomial_pass(n, plan, xr.clone(), xi.clone(), inplace=True, kernel=True)
    assert cuda_build.LAUNCHES["monomial_pass"] == before + 1
    pr, pi = monomial.monomial_pass(n, plan, xr, xi, inplace=False, kernel=False)
    torch.cuda.synchronize()
    return (kr, ki), (pr, pi), (xr, xi)


@pytest.mark.parametrize("control", [0, 7, T - 1, None], ids=["top", "mid", "beside", "none"])
def test_shor_multiplication_is_bit_equal(cuda, control):
    """Counting qubit ``control`` (flat bit 23 - control; T - 1 is flat bit
    10, just above the work register) times a^8 mod 1007 on the work
    qubits T .. 23: moves only, so the kernel equals the plain pass bit for
    bit, and the untouched half stays as it was."""
    inner = DenseOp(tuple(range(T, N)), _mod_mult_permutation(pow(2, 8, 1007), 1007, 10))
    op = inner if control is None else make_control_op([control], inner)
    (kr, ki), (pr, pi), (xr, xi) = _both(N, op, cuda, seed=control or 0)
    assert torch.equal(kr, pr) and torch.equal(ki, pi)
    assert not torch.equal(kr, xr)
    if control is not None:
        bit = N - 1 - control
        rows = (torch.arange(kr.shape[0], device=cuda) >> (bit - 7)) & 1 == 0
        assert torch.equal(kr[rows], xr[rows]) and torch.equal(ki[rows], xi[rows])


def _random_monomial(rng, k):
    perm = rng.permutation(1 << k)
    while np.array_equal(perm, np.arange(1 << k)):
        perm = rng.permutation(1 << k)
    mat = np.zeros((1 << k, 1 << k), dtype=np.complex128)
    mat[perm, np.arange(1 << k)] = np.exp(2j * np.pi * rng.random(1 << k))
    return mat


@pytest.mark.parametrize("targets, controls", [
    ((20, 23, 17, 21), ()),          # lanes only, scattered
    ((22, 23, 21, 16, 15, 14), (3,)),  # the lowest lanes and three row bits
    ((2, 9, 5), (0, 11, 16)),        # rows only
    ((0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11), (20,)),  # twelve row bits, the widest op
    ((12, 23), (1, 2)),              # a row bit and the last lane
    ((5, 12, 20), (23,)),            # a control on lane bit 0: no 16-byte units
], ids=["lanes", "lanes_and_rows", "rows", "twelve_rows", "row_and_lane", "lane0_control"])
def test_phases_within_float32(cuda, targets, controls):
    rng = np.random.default_rng(len(targets) * 7 + len(controls))
    inner = DenseOp(tuple(targets), _random_monomial(rng, len(targets)))
    op = make_control_op(list(controls), inner) if controls else inner
    (kr, ki), (pr, pi), (xr, xi) = _both(N, op, cuda, seed=len(targets))
    scale = max(xr.abs().max().item(), xi.abs().max().item())
    assert (kr - pr).abs().max().item() <= 2.0 ** -23 * scale
    assert (ki - pi).abs().max().item() <= 2.0 ** -23 * scale


def test_fresh_planes_leave_the_input(cuda):
    inner = DenseOp(tuple(range(T, N)), _mod_mult_permutation(3, 1007, 10))
    plan = monomial.plan_of(N, make_control_op([2], inner))
    xr, xi = _planes(N, cuda, 5)
    keep = (xr.clone(), xi.clone())
    yr, yi = monomial.monomial_pass(N, plan, xr, xi, inplace=False, kernel=True)
    torch.cuda.synchronize()
    assert torch.equal(xr, keep[0]) and torch.equal(xi, keep[1])
    assert yr.data_ptr() != xr.data_ptr() and not torch.equal(yr, xr)


def test_shor24_runs_one_launch_a_multiplication_in_bounded_scratch(cuda):
    """Shor at n = 24 (t = 14, N = 1007) through its compiled sweeps, one by
    one, on planes the run owns: every monomial pass launches once and
    leaves the allocator's peak within one block of scratch of the state;
    the run's distribution is the plain reference's."""
    cfg = {"num_qubits": N, "counting_qubits": T, "work_qubits": 10, "modulus": 1007}
    params = {"base": shor_reference.bases(1007)[0]}
    b = LocalBuilder(dtype="f32", device=cuda)
    shor_circuit.build(b, cfg, params)
    cc = b.compile()
    re, im = cc._one_hot(0)
    scratch = port_types.PASS_BLOCK * 4 * 2
    passes, probs = 0, None
    counts = dict(observe.COUNTS)
    for seg in cc.sweeps:
        if isinstance(seg, MeasureEntry):
            probs = measure_probs_ri(N, seg.indices, re, im)
            continue
        for sweep in seg:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(cuda)
            torch.cuda.reset_peak_memory_stats(cuda)
            launches = cuda_build.LAUNCHES["monomial_pass"]
            re, im = run_sweeps(N, [sweep], re, im, inplace=True)
            torch.cuda.synchronize()
            if cuda_build.LAUNCHES["monomial_pass"] > launches:
                assert cuda_build.LAUNCHES["monomial_pass"] == launches + 1
                assert torch.cuda.max_memory_allocated(cuda) - base <= scratch
                passes += 1
    assert passes == T
    assert observe.COUNTS["monomial_pass"] - counts.get("monomial_pass", 0) == T
    ref = shor_reference.solve(cfg, params, 0, device=cuda)
    got = probs.double().cpu().numpy()
    assert np.abs(got - ref["probs"]).max() / ref["probs"][0] < 1e-4


def test_kernels_off_take_the_plain_pass(cuda):
    """Shor at n = 24 compiled with the kernels off (``kernel_ok=False``):
    ``CompiledCircuit.run`` takes the plain monomial pass and the plain
    swaps, so it launches none of the permutation kernels; its distribution
    is the kernel path's within 1e-4 of P(0), the cell's limit."""
    cfg = {"num_qubits": N, "counting_qubits": T, "work_qubits": 10, "modulus": 1007}
    params = {"base": shor_reference.bases(1007)[0]}
    names = ("monomial_pass", "row_swap", "row_swap_cross", "plane_copy")
    got = {}
    for kernel_ok in (None, False):
        b = LocalBuilder(dtype="f32", device=cuda, kernel_ok=kernel_ok)
        shor_circuit.build(b, cfg, params)
        cc = b.compile()
        before = {k: cuda_build.LAUNCHES[k] for k in names}
        _, _, res = cc.run(0, generator=torch.Generator().manual_seed(3))
        torch.cuda.synchronize()
        launched = {k: cuda_build.LAUNCHES[k] - before[k] for k in names}
        probs = next(r for r in res if not isinstance(r, tuple))
        got[kernel_ok] = probs.double().cpu().numpy()
        if kernel_ok is None:
            assert launched["monomial_pass"] == T
        else:
            assert launched == dict.fromkeys(names, 0)
    assert np.abs(got[None] - got[False]).max() / got[False][0] < 1e-4
