"""The port's row-swap and copy kernels on a CUDA device against their plain
torch versions (bit for bit), a controlled wide swap, the oracle ops and
``measure_prob_fn``'s tier 1 on the card against the CPU. Marked ``gpu``:
skips without a card; imports no JAX (see ``test_torch_gpu.py``).
"""

import numpy as np
import pytest
import torch

from rustqip_tpu_torch.engine import cuda_build
from rustqip_tpu_torch.engine import copy_probe, row_swap
from rustqip_tpu_torch.interop import planes_from_numpy, planes_to_numpy

TOL = 1e-6

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


SWAP_SETS = row_swap.parity_pair_sets(20)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("idx", range(len(SWAP_SETS)), ids=[s[0] for s in SWAP_SETS])
def test_row_swap_kernel_equals_plain(cuda, idx, dtype):
    """A permutation computes nothing: the kernel equals the plain version
    bit for bit, and counts one launch."""
    _, pairs = SWAP_SETS[idx]
    n = 20
    x = planes_from_numpy(_state(n, 2), dtype=dtype, device=cuda)
    want = row_swap.row_swap_reference(n, pairs, *x)
    before = cuda_build.LAUNCHES["row_swap"]
    got = row_swap.row_swap(n, pairs, x[0].clone(), x[1].clone())
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["row_swap"] == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_conditioned_wide_swap_on_cuda_matches_cpu(cuda):
    """A controlled swap of two 6-qubit registers (a ControlOp wider than
    DENSE_CAP) at n = 20, where every pair is a row pair: the inner row
    swap runs in place on the card, on the copies ``_control_ri`` takes,
    so the card equals the CPU and the input is left alone."""
    from rustqip_tpu_torch.engine.real_apply import apply_op_ri
    from rustqip_tpu_torch.ops.matrix_ops import make_control_op, make_swap_op

    n = 20
    op = make_control_op([0], make_swap_op(range(1, 7), range(7, 13)))
    v = _state(n, 3)
    x = planes_from_numpy(v, device=cuda)
    x0 = (x[0].clone(), x[1].clone())
    before = (cuda_build.LAUNCHES["row_swap"], cuda_build.LAUNCHES["plane_copy"])
    got = planes_to_numpy(*apply_op_ri(n, op, *x))
    assert cuda_build.LAUNCHES["row_swap"] == before[0] + 1
    assert cuda_build.LAUNCHES["plane_copy"] == before[1] + 1
    assert torch.equal(x[0], x0[0]) and torch.equal(x[1], x0[1])
    want = planes_to_numpy(*apply_op_ri(n, op, *planes_from_numpy(v, device="cpu")))
    assert np.abs(got - want).max() == 0.0


@pytest.mark.parametrize("numel", [1 << 20, 3 * 8192 + 16], ids=["n20", "not_a_chunk_multiple"])
@pytest.mark.parametrize("strips", [1, 4])
@pytest.mark.parametrize("inplace", [False, True], ids=["fresh", "inplace"])
def test_plane_copy_kernel_equals_copy(cuda, strips, inplace, numel):
    """The copy moves bits: equal to its input, fresh and in place, at
    n = 20 and at a plane of 98368 bytes (no multiple of a block's 4 KB per
    strip, nor of a 32 KB chunk), and counts one launch."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((2, numel), generator=g, device=cuda)
    xr, xi = x[0].clone(), x[1].clone()
    out = (xr, xi) if inplace else None
    before = cuda_build.LAUNCHES["plane_copy"]
    yr, yi = copy_probe.plane_copy(xr, xi, out=out, strips=strips)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["plane_copy"] == before + 1
    assert (yr.data_ptr() == xr.data_ptr()) == inplace
    assert torch.equal(yr, x[0]) and torch.equal(yi, x[1])


def _phase_perm(row):
    """An affine permutation of 5 bits with a phase exp(0.7 i row)."""
    return (row * 5 + 3) % 32, torch.polar(torch.ones(row.shape, dtype=torch.float64,
                                                      device=row.device),
                                           0.7 * row.to(torch.float64))


def _xor_f(x):
    return (3 * x + 1) % 64, 1


def _oracle_ops():
    from rustqip_tpu_torch.ops import matrix_ops as P

    rng = np.random.default_rng(11)
    perm = rng.permutation(1 << 12)
    phase = np.exp(1j * rng.uniform(-3, 3, 1 << 12))
    return {
        "fn_general": P.make_fn_op([0, 7, 3, 15, 18], _phase_perm),
        "fn_diagonal": P.make_fn_op(list(range(20)), lambda r: (r, torch.where(
            r % 7 == 0, -1.0, 1.0)), diagonal=True),
        "fn_controlled": P.make_control_op(
            [0], P.make_function_op(range(2, 8), range(8, 14), _xor_f)),
        "sparse_wide": P.make_sparse_matrix_op(
            [19, 1, 5, 2, 9, 3, 7, 12, 10, 4, 6, 16],
            [[(int(perm[i]), complex(phase[i]))] for i in range(1 << 12)]),
    }


ORACLE_OPS = _oracle_ops()


@pytest.mark.parametrize("name", sorted(ORACLE_OPS))
def test_oracle_ops_on_cuda_match_cpu(cuda, name):
    """Function ops (gather and diagonal), a controlled function op on 13
    indices and a 12-qubit sparse op at n = 20: the card equals the CPU
    within 1e-6, and the input planes are left alone. No op copies its
    input with plane_copy: the gather passes return fresh planes, so the
    controlled function op takes none either."""
    from rustqip_tpu_torch.engine.real_apply import apply_op_ri

    n = 20
    op = ORACLE_OPS[name]
    v = _state(n, 6)
    x = planes_from_numpy(v, device=cuda)
    x0 = (x[0].clone(), x[1].clone())
    before = cuda_build.LAUNCHES["plane_copy"]
    got = planes_to_numpy(*apply_op_ri(n, op, *x))
    assert cuda_build.LAUNCHES["plane_copy"] == before
    assert torch.equal(x[0], x0[0]) and torch.equal(x[1], x0[1])
    want = planes_to_numpy(*apply_op_ri(n, op, *planes_from_numpy(v, device="cpu")))
    assert np.abs(got - want).max() <= TOL


def test_measure_prob_fn_tier1_on_cuda_equals_tier2(cuda):
    """The card's tier (int32 index chunks, here 8 of them) equals the numpy
    tier on the same amplitude function."""
    from rustqip_tpu_torch.ops import measurement_ops as M

    n = 20
    amps = _state(n, 8)
    tab = torch.as_tensor(amps, device=cuda)

    def on_card(i):
        return tab[torch.as_tensor(i, device=cuda).long()]

    def numpy_only(i):
        if isinstance(i, torch.Tensor):
            raise TypeError("numpy only")
        return amps[np.asarray(i)]

    old = M.DEVICE_CHUNK
    M.DEVICE_CHUNK = 1 << 16
    try:
        for indices, m in (([0], 1), ([3, 17], 2), ([19, 4, 11], 5)):
            d0, v0 = M.TIER_CALLS["device"], M.TIER_CALLS["vectorized"]
            got = M.measure_prob_fn(n, m, indices, on_card)
            want = M.measure_prob_fn(n, m, indices, numpy_only)
            assert M.TIER_CALLS["device"] == d0 + 1
            assert M.TIER_CALLS["vectorized"] == v0 + 1
            assert abs(got - want) <= 1e-12
    finally:
        M.DEVICE_CHUNK = old
