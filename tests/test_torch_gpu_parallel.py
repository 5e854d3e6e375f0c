"""The sharded state vector (``parallel/``) on a CUDA device, at n = 20 on
4 shards of cuda:0: the explicit executor against the single-device
kernel path of the same circuit, launching the window kernel on its
shard-local runs; the kernel-off (gspmd counterpart) executor launching it
0 times; and a 20-qubit XOR ``FnOp`` through the ``gex`` exchange. Marked
``gpu``: skips without a card; imports no JAX (see ``test_torch_gpu.py``).
"""

import numpy as np
import pytest
import torch

from rustqip_tpu_torch.engine import cuda_build

N = 20
SHARDS = 4
TOL = 1e-5  # float32 end to end

pytestmark = pytest.mark.gpu

torch.set_num_threads(1)  # the test runner keeps one worker per core busy


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's Hopper kernels")
    return torch.device("cuda")


def _mesh():
    from rustqip_tpu_torch.parallel import make_shard_mesh

    return make_shard_mesh(SHARDS, devices=["cuda:0"] * SHARDS)


def _circuit(b):
    """Seam gates, a QFT and a Grover-style reflection on every qubit."""
    from rustqip_tpu_torch.algos import qfft

    qs = b.split_all_register(b.register(N))
    qs[0] = b.h(qs[0])
    qs[0], qs[-1] = b.cnot(qs[0], qs[-1])
    qs[1], qs[-2] = b.swap(qs[1], qs[-2])
    r = qfft(b, b.merge_registers(qs))
    b.apply_reflection(r)


def _single(b):
    from rustqip_tpu_torch.interop import planes_to_numpy

    re, im, _ = b.compile().run(0)
    return planes_to_numpy(re, im)


def _sharded(strategy):
    from rustqip_tpu_torch.parallel import sharded_calculate_state
    from rustqip_tpu_torch.parallel.explicit import gather_state
    from rustqip_tpu_torch.prelude import LocalBuilder

    b = LocalBuilder(dtype="f32", device="cuda")
    _circuit(b)
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    re, im, _ = sharded_calculate_state(b, mesh=_mesh(), seed=0, strategy=strategy)
    torch.cuda.synchronize()
    assert len(re) == SHARDS and all(r.is_cuda for r in re)
    return gather_state(re, im), cuda_build.LAUNCHES["window_sweep"]


def test_explicit_shards_launch_the_kernel_and_match_one_device(cuda):
    from rustqip_tpu_torch.prelude import LocalBuilder

    b = LocalBuilder(dtype="f32", device="cuda")
    _circuit(b)
    want = _single(b)
    got, launches = _sharded("explicit")
    assert launches > 0
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_gspmd_counterpart_launches_no_kernel(cuda):
    from rustqip_tpu_torch.prelude import LocalBuilder

    b = LocalBuilder(dtype="f32", device="cuda")
    _circuit(b)
    got, launches = _sharded("gspmd")
    assert launches == 0
    np.testing.assert_allclose(got, _single(b), atol=TOL, rtol=0)


def test_gex_xor_oracle_on_cuda_matches_cpu(cuda):
    """A 20-qubit XOR FnOp spans every qubit, so no global can relocate:
    the gex exchange, against the same shards on the CPU."""
    from rustqip_tpu_torch.ops import gates
    from rustqip_tpu_torch.ops.matrix_ops import make_fn_op, make_matrix_op
    from rustqip_tpu_torch.parallel import make_shard_mesh
    from rustqip_tpu_torch.parallel.explicit import gather_state
    from rustqip_tpu_torch.parallel.shard_ops import (
        _lower_schedule,
        apply_sharded_ops,
        make_sharded_pair,
    )

    def xor_oracle(row):
        return row ^ (((row >> 2) * 5 + 1) & 3), 1.0

    ops = [make_matrix_op([q], gates.H.reshape(-1)) for q in (0, 5, N - 1)]
    ops.append(make_fn_op(list(range(N)), xor_oracle, tag="gpu-xor-20", self_transpose=True))
    assert [e[0] for e in _lower_schedule(N, 2, ops)][-1] == "gex"
    states = []
    for devices in (["cuda:0"] * SHARDS, ["cpu"] * SHARDS):
        mesh = make_shard_mesh(SHARDS, devices=devices)
        re, im = apply_sharded_ops(mesh, N, ops, *make_sharded_pair(mesh, N, 6))
        states.append(gather_state(re, im))
    np.testing.assert_allclose(states[0], states[1], atol=TOL, rtol=0)
    assert abs(np.linalg.norm(states[0]) - 1) < TOL
