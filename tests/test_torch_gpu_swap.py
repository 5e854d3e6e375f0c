"""The swap pass's cross kernel on a CUDA device: a whole ``SwapOp`` with
cross pairs (a row qubit with a lane qubit) in one launch of
``cross_row_swap_kernel``, bit for bit equal to the plain cross pass and
row pass it replaces, in place and to fresh planes, in float32 and
float64; a ``SwapOp`` of row pairs alone still launches ``row_swap_kernel``
once; a lone cross pair runs as a dense pass and is counted as a plain
fallback. Marked ``gpu``: skips without a card; imports no JAX (see
``test_torch_gpu.py``).
"""

from collections import Counter

import pytest
import torch

from rustqip_tpu_torch.engine import cuda_build
from rustqip_tpu_torch.engine import row_swap
from rustqip_tpu_torch.engine.apply import _cross_swap_planes, _row_swap_planes, _swap_schedule
from rustqip_tpu_torch.engine.real_apply import apply_op_ri
from rustqip_tpu_torch.ops.matrix_ops import make_swap_op
from rustqip_tpu_torch.utils import observe

pytestmark = pytest.mark.gpu

torch.set_num_threads(1)  # the test runner keeps one worker per core busy

N = 20
CROSS_SETS = row_swap.cross_pair_sets(N)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's Hopper kernels")
    return torch.device("cuda")


def _planes(dtype, device, seed):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    x = torch.randn((2, 1 << (N - 7), 128), generator=g, device=device, dtype=dtype)
    return x[0], x[1]


def _swap_op(pairs):
    return make_swap_op([a for a, _ in pairs], [b for _, b in pairs])


@pytest.mark.parametrize("inplace", [True, False], ids=["inplace", "fresh"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("idx", range(len(CROSS_SETS)), ids=[s[0] for s in CROSS_SETS])
def test_cross_kernel_equals_plain_passes(cuda, idx, dtype, inplace):
    """k = 2, 3, 6 and 7 cross pairs, with and without row pairs (QFT-20's
    reversal, a QPE-like one): ``apply_op_ri`` launches the cross kernel
    once and no row kernel, and equals ``_cross_swap_planes`` then
    ``_row_swap_planes`` exactly. In place it keeps the caller's storage;
    otherwise it leaves the input bit-equal."""
    _, pairs = CROSS_SETS[idx]
    op = _swap_op(pairs)
    cross, rowp, colp, mixed = _swap_schedule(N, op)
    assert len(cross) >= 2 and not colp and not mixed
    xr, xi = _planes(dtype, cuda, 30 + idx)
    keep = (xr.clone(), xi.clone())
    want = _cross_swap_planes(N, cross, [xr, xi])
    if rowp:
        want = _row_swap_planes(N, rowp, want)
    before = Counter(cuda_build.LAUNCHES)
    plain = observe.COUNTS["swap_cross_plain"]
    got = apply_op_ri(N, op, xr, xi, inplace=inplace)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["row_swap_cross"] == before["row_swap_cross"] + 1
    assert cuda_build.LAUNCHES["row_swap"] == before["row_swap"]
    assert observe.COUNTS["swap_cross_plain"] == plain
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if inplace:
        assert (got[0].data_ptr(), got[1].data_ptr()) == (xr.data_ptr(), xi.data_ptr())
    else:
        assert torch.equal(xr, keep[0]) and torch.equal(xi, keep[1])


def test_row_only_swap_op_launches_the_row_kernel_once(cuda):
    """A reversal of 12 row qubits, no cross pair: one ``row_swap`` launch,
    as before the cross kernel, equal to its plain version."""
    pairs = [(j, 11 - j) for j in range(6)]
    xr, xi = _planes(torch.float32, cuda, 7)
    want = row_swap.row_swap_reference(N, pairs, xr, xi)
    before = Counter(cuda_build.LAUNCHES)
    got = apply_op_ri(N, _swap_op(pairs), xr.clone(), xi.clone())
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["row_swap"] == before["row_swap"] + 1
    assert cuda_build.LAUNCHES["row_swap_cross"] == before["row_swap_cross"]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _bit_swaps(pairs, x):
    """The plane ``x`` with the op's qubit pairs exchanged in its flat index
    (qubit q is bit N - 1 - q), by one gather."""
    idx = torch.arange(1 << N, device=x.device)
    src = idx.clone()
    for a, b in pairs:
        d = ((idx >> (N - 1 - a)) ^ (idx >> (N - 1 - b))) & 1
        src ^= (d << (N - 1 - a)) | (d << (N - 1 - b))
    return x.reshape(-1)[src].reshape(x.shape)


def test_lone_cross_pair_is_counted_as_a_plain_fallback(cuda):
    """One cross pair with row pairs: the cross pass takes two pairs or
    more, so the rows launch ``row_swap`` and the cross pair runs as a dense
    4 x 4 pass, counted once in ``swap_cross_plain``; within 1e-6 of the
    op's bit swaps (the dense pass multiplies)."""
    pairs = [(0, N - 1), (2, 9), (3, 8)]
    xr, xi = _planes(torch.float32, cuda, 8)
    before = Counter(cuda_build.LAUNCHES)
    plain = observe.COUNTS["swap_cross_plain"]
    got = apply_op_ri(N, _swap_op(pairs), xr.clone(), xi.clone())
    torch.cuda.synchronize()
    assert observe.COUNTS["swap_cross_plain"] == plain + 1
    assert cuda_build.LAUNCHES["row_swap"] == before["row_swap"] + 1
    assert cuda_build.LAUNCHES["row_swap_cross"] == before["row_swap_cross"]
    for g, x in zip(got, (xr, xi)):
        assert (g.reshape(x.shape) - _bit_swaps(pairs, x)).abs().max().item() <= 1e-6
