"""This slice's modules on a CUDA device against the CPU, at n = 20: a
QASM-imported and a JSON-replayed circuit run through the kernels,
``observe.profile_passes`` timed with CUDA events, the trace hook, the
controlled XOR oracle without a ``plane_copy``, and the two-stage outcome
draw giving the same outcome for a seed on the card and on the CPU. Marked
``gpu``: skips without a card; imports no JAX (see ``test_torch_gpu.py``).
"""

import numpy as np
import pytest
import torch

from rustqip_tpu_torch.engine import cuda_build

N = 20
# The QFT's input register value, every bit set: the QFT applies each
# controlled phase while its control is still a basis qubit, so a phase
# acts only where its control's input bit is 1.
X_IN = (1 << N) - 1

pytestmark = pytest.mark.gpu

torch.set_num_threads(1)  # the test runner keeps one worker per core busy


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's Hopper kernels")
    return torch.device("cuda")


def _circuit(b):
    """X on the qubits of X_IN's ones, then QFT over all N qubits."""
    from rustqip_tpu_torch.algos import qfft

    qs = list(b.split_all_register(b.register(N)))
    qs = [b.x(q) if (X_IN >> j) & 1 else q for j, q in enumerate(qs)]
    qfft(b, b.merge_registers(qs))


def _closed_form():
    """The QFT of the basis state that ``_circuit`` prepares: the DFT on
    big-endian state indices, exp(2 pi i x k / 2^N) / 2^(N/2)."""
    x = sum(((X_IN >> j) & 1) << (N - 1 - j) for j in range(N))
    k = np.arange(1 << N, dtype=np.int64)
    return np.exp(2j * np.pi * ((x * k) % (1 << N)) / (1 << N)) / 2 ** (N / 2)


@pytest.mark.parametrize("route", ["qasm", "json"])
def test_imported_circuit_on_cuda_matches_cpu(cuda, route):
    """The circuit exported and re-imported on the card runs through the
    window kernel and the swap pass's cross kernel (its QFT's reversal
    holds cross pairs: one launch takes them with the row pairs), equals
    the CPU import within 1e-5 and the closed form within 1e-6."""
    from rustqip_tpu_torch.prelude import LocalBuilder
    from rustqip_tpu_torch.qasm import circuit_from_qasm
    from rustqip_tpu_torch.utils import serialize

    b = LocalBuilder(dtype="f32", device="cpu")
    _circuit(b)
    states = []
    for device in (cuda, "cpu"):
        if route == "qasm":
            imp = circuit_from_qasm(b.to_openqasm(),
                                    builder=LocalBuilder(dtype="f32", device=device)).builder
        else:
            imp = serialize.builder_from_json(serialize.circuit_to_json(b), dtype="f32",
                                              device=device)
        before = (cuda_build.LAUNCHES["window_sweep"], cuda_build.LAUNCHES["row_swap_cross"])
        states.append(imp.calculate_state(seed=0)[0])
        if device is cuda:
            assert cuda_build.LAUNCHES["window_sweep"] > before[0]
            assert cuda_build.LAUNCHES["row_swap_cross"] > before[1]
    assert np.abs(states[0] - states[1]).max() <= 1e-5
    want = _closed_form()
    assert max(np.abs(s - want).max() for s in states) <= 1e-6


def test_profile_passes_on_cuda(cuda):
    """Per-sweep times by CUDA events, one entry per sweep of the plan, with
    ``pass_breakdown``'s keys; their sum is near one whole run's."""
    from rustqip_tpu_torch.prelude import LocalBuilder
    from rustqip_tpu_torch.utils import observe

    b = LocalBuilder(dtype="f32", device=cuda)
    _circuit(b)
    out = observe.profile_passes(b, iters=3)
    static = [e for e in observe.pass_breakdown(b) if e["kind"] != "measure"]
    assert len(out) == len(static)
    assert [{k: e[k] for k in s} for e, s in zip(out, static)] == static
    assert all(e["ms"] > 0 and e["gbps"] > 0 for e in out)
    assert sum(e["kernel"] for e in out) == b.compile().sweep_counts()["kwindow"] > 0
    fused = observe.profile_passes_fused(b, extra_reps=3, iters=2)
    assert [e["kind"] for e in fused] == [e["kind"] for e in out]


def test_trace_records_device_kernels(cuda, tmp_path):
    from rustqip_tpu_torch.prelude import LocalBuilder
    from rustqip_tpu_torch.utils import observe

    b = LocalBuilder(dtype="f32", device=cuda)
    _circuit(b)
    cc = b.compile()
    cc.run(0)
    with observe.trace(str(tmp_path)):
        cc.run(0)
    s = observe.trace_summary(str(tmp_path / "trace.json"))
    assert s["kernel_events"] >= cc.sweep_counts()["kwindow"]
    assert 0 < s["busy_share"] <= 1


def test_controlled_xor_oracle_takes_no_plane_copy(cuda):
    """A controlled function oracle wider than DENSE_CAP launches no
    ``plane_copy`` on the card and equals the CPU within 1e-5."""
    from rustqip_tpu_torch.prelude import LocalBuilder

    states = []
    for device in (cuda, "cpu"):
        b = LocalBuilder(dtype="f32", device=device)
        q = b.h(b.qubit())
        rx, ry = b.h(b.register(8)), b.register(8)
        cb = b.condition_with(q)
        cb.apply_function_op(rx, ry, lambda x: ((5 * x + 3) % 256, 1))
        cb.dissolve()
        b.register(N - 17)
        before = cuda_build.LAUNCHES["plane_copy"]
        states.append(b.calculate_state(seed=0)[0])
        assert cuda_build.LAUNCHES["plane_copy"] == before
    assert np.abs(states[0] - states[1]).max() <= 1e-5


def test_two_stage_draw_same_outcome_on_cuda_and_cpu(cuda):
    """Above 2^16 outcomes the draw reads two float64 vectors; a seed gives
    the same outcomes from the card's distribution as from the CPU's."""
    from rustqip_tpu_torch.ops.measurement_ops import ONE_STAGE_MAX, sample_outcome

    g = torch.Generator().manual_seed(3)
    p = torch.rand(1 << N, generator=g, dtype=torch.float64) ** 8
    p /= p.sum()
    assert p.numel() > ONE_STAGE_MAX
    draws = []
    for x in (p.to(cuda), p):
        gen = torch.Generator().manual_seed(11)
        draws.append([sample_outcome(x, gen) for _ in range(16)])
    assert draws[0] == draws[1]
