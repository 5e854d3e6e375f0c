"""The state-vector API on a CUDA device at n = 20 in complex64: QFT-20's
op list through ``engine.apply_ops`` (the window kernel once per kernel
window of the plan, the row-swap kernel once per ``SwapOp`` with row
pairs, the input left bit-equal), a lane ``apply_op`` (one
``c64_low_matmul`` launch), a row-pair ``SwapOp`` (one ``row_swap``
launch, exact) and the complex measurement API against the plane
functions, each against the plain torch version on the same card (1e-6).
Marked ``gpu``: skips without a card; imports no JAX (see
``test_torch_gpu.py``).
"""

import numpy as np
import pytest
import torch

from rustqip_tpu_torch.engine import cuda_build
from rustqip_tpu_torch.engine import apply_op, apply_ops
from rustqip_tpu_torch.engine import row_swap
from rustqip_tpu_torch.engine import window_kernel as wk
from rustqip_tpu_torch.engine.admission import HOPPER
from rustqip_tpu_torch.engine.apply import _dense_plan, _mat_key, _swap_schedule
from rustqip_tpu_torch.engine.real_apply import compile_sweeps, run_sweeps
from rustqip_tpu_torch.ops import MeasuredCondition, measure, measure_probs, prob_magnitude
from rustqip_tpu_torch.ops.matrix_ops import SwapOp, make_matrix_op, make_swap_op
from rustqip_tpu_torch.ops.measurement_ops import measure_probs_ri, measure_ri, measure_state_ri
from rustqip_tpu_torch.types import join_planes, split_state

N = 20
TOL = 1e-6

pytestmark = pytest.mark.gpu

torch.set_num_threads(1)  # the test runner keeps one worker per core busy


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's Hopper kernels")
    return torch.device("cuda")


def _state(device, seed=20):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    x = torch.randn(1 << N, dtype=torch.complex64, device=device, generator=g)
    return x / torch.linalg.vector_norm(x)


def _launches():
    torch.cuda.synchronize()
    return (cuda_build.LAUNCHES["window_sweep"], cuda_build.LAUNCHES["row_swap"],
            cuda_build.LAUNCHES["plane_copy"])


def _diff(c, re, im):
    c = c.reshape(re.shape)
    return max((c.real - re).abs().max().item(), (c.imag - im).abs().max().item())


def _qft_ops():
    from rustqip_tpu_torch.algos import qfft
    from rustqip_tpu_torch.builder.builder import _lower_item
    from rustqip_tpu_torch.prelude import LocalBuilder

    b = LocalBuilder(dtype="f32", device="cuda")
    qfft(b, b.register(N))
    return [e.op for item in b.pipeline for e in _lower_item(item)]


def test_apply_ops_qft_launches_kernels_and_keeps_input(cuda):
    state = _state(cuda)
    keep = state.clone()
    ops = _qft_ops()
    kwindows = sum(k == "kwindow" for k, _, _ in compile_sweeps(N, ops, True, HOPPER))
    row_swaps = sum(isinstance(op, SwapOp) and bool(_swap_schedule(N, op)[1]) for op in ops)
    before = _launches()
    out = apply_ops(N, ops, state)
    after = _launches()
    assert after[0] - before[0] == kwindows > 0
    assert after[1] - before[1] == row_swaps > 0
    assert torch.equal(state, keep)
    before = _launches()
    pr, pi = run_sweeps(N, compile_sweeps(N, ops, False, HOPPER), *split_state(N, state, None),
                        low_kernel=False, swap_kernel=False)
    assert _launches() == before  # the plain path launches no kernel
    assert _diff(out, pr, pi) <= TOL
    assert abs(float(prob_magnitude(out)) - 1.0) <= 1e-5


def test_lane_apply_op_is_one_low_matmul_launch(cuda):
    state = _state(cuda, 21)
    rng = np.random.default_rng(26)
    u = np.linalg.qr(rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4)))[0]
    lane = make_matrix_op([N - 2, N - 1], u.reshape(-1))
    before = _launches()
    out = apply_op(N, lane, state)
    after = _launches()
    assert (after[0] - before[0], after[1] - before[1]) == (1, 0)
    B = _dense_plan(N, lane.indices, _mat_key(lane.data))[1]
    assert _diff(out, *wk.c64_low_matmul(*split_state(N, state, None), B, kernel=False)) <= TOL


def test_row_pair_swap_apply_op_is_exact(cuda):
    state = _state(cuda, 22)
    keep = state.clone()
    pairs = [(q, N - 1 - q) for q in range(N // 2) if N - 1 - q < N - 7]
    before = _launches()
    out = apply_op(N, make_swap_op(*zip(*pairs)), state)
    after = _launches()
    assert (after[0] - before[0], after[1] - before[1]) == (0, 1)
    want = row_swap.row_swap_reference(N, pairs, *split_state(N, state, None))
    assert torch.equal(out, join_planes(*want))
    assert torch.equal(state, keep)


def test_measurement_api_matches_planes(cuda):
    state = _state(cuda, 23)
    idx = list(range(2, 18))
    re, im = split_state(N, state, None)
    probs_ri = measure_probs_ri(N, idx, re, im)
    probs = measure_probs(N, idx, state)
    assert ((probs - probs_ri).abs().max() / probs_ri.max()).item() <= TOL
    # a numpy state is measured on the card unless the caller asks for the CPU
    host = state.cpu().numpy()
    on_card = measure_probs(N, idx, host)
    assert on_card.device.type == "cuda"
    on_host = measure_probs(N, idx, host, device="cpu")
    assert ((on_card.cpu() - on_host).abs().max() / on_host.max()).item() <= TOL
    m = int(torch.argmax(probs_ri))
    outcome, prob, col = measure(N, idx, state, measured=MeasuredCondition(m))
    assert outcome == m
    assert _diff(col, *measure_state_ri(N, idx, (m, float(probs_ri[m])), re, im)) <= TOL
    assert abs(float(prob_magnitude(col)) - 1.0) <= 1e-5
    for seed in (1, 2):
        g1, g2 = torch.Generator(), torch.Generator()
        g1.manual_seed(seed)
        g2.manual_seed(seed)
        assert measure(N, idx, state, generator=g1)[0] == measure_ri(N, idx, re, im, generator=g2)[0]
