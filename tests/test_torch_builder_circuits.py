"""QFT and Grover through the port's ``LocalBuilder`` against the JAX
package's builder, in f64 (1e-10) and f32 (1e-5 end to end), with the
kernel path on (kernel windows through the kernel's plain version on the
CPU) and off. Each reference state is computed once per module."""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from rustqip_tpu_torch.algos import grover_iteration, qfft  # noqa: E402
from rustqip_tpu_torch.prelude import LocalBuilder  # noqa: E402

torch.set_num_threads(1)  # the test runner keeps one worker per core busy

TOL = {"f64": 1e-10, "f32": 1e-5}


def _qft_build(n):
    def build(b, side):
        if side == "ref":
            from rustqip_tpu.algos import qfft as f
        else:
            f = qfft
        r = b.register(n)
        f(b, r)
        return [(r, 0b1011)]

    return build


def _grover_build(n, native=False):
    def build(b, side):
        if side == "ref":
            from rustqip_tpu.algos.grover import grover_iteration as f
        else:
            f = grover_iteration
        r = b.h(b.register(n))
        f(b, r, 0b10110 & ((1 << n) - 1), native_diffusion=native)
        return []

    return build


CIRCUITS = {
    "qft10": _qft_build(10),
    "grover10": _grover_build(10),
    "grover10_native": _grover_build(10, native=True),
    "qft14": _qft_build(14),
    "grover14": _grover_build(14),
}


@functools.lru_cache(maxsize=None)
def _reference_state(name, prec):
    from rustqip_tpu.prelude import LocalBuilder as RB

    b = RB(dtype=prec)
    init = CIRCUITS[name](b, "ref")
    state, _ = b.calculate_state_with_init(init, seed=0)
    return np.asarray(state, dtype=np.complex128)


@pytest.mark.parametrize("kernel_ok", [False, True])
@pytest.mark.parametrize(
    "name,prec",
    [("qft10", "f64"), ("qft10", "f32"), ("grover10", "f64"),
     ("grover10", "f32"), ("grover10_native", "f32"),
     ("qft14", "f32"), ("grover14", "f32")],
)
def test_circuit_matches_reference(name, prec, kernel_ok):
    b = LocalBuilder(dtype=prec, device="cpu", kernel_ok=kernel_ok)
    init = CIRCUITS[name](b, "port")
    cc = b.compile()
    counts = cc.sweep_counts()
    if kernel_ok and prec == "f32" and name.endswith("14"):
        assert counts["kwindow"] > 0  # the kernel windows really ran
    if not kernel_ok or prec == "f64":
        assert counts["kwindow"] == 0
    state, _ = b.calculate_state_with_init(init, seed=0)
    want = _reference_state(name, prec)
    assert np.abs(state.astype(np.complex128) - want).max() <= TOL[prec]
