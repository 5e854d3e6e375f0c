"""The circuits of ``chip_smoke.phase_capacity`` through the port's main
path (``LocalBuilder`` -> ``compile()`` -> ``CompiledCircuit.run``) at
n = 12 on the CPU, with ``types.PASS_BLOCK`` cut to a few rows, against the
JAX package's ``CompiledCircuit.run`` of the same circuits: the JAX
package's capacity circuit (``benches/capacity_single_chip.py``) with its
outcome forced, QFT-12 of the basis state with all bits set and one
Grover-12 iteration with native diffusion, each also against the closed
form ``chip_smoke.py`` holds the n = 32 run to. The JAX package runs in
float64; the port's float64 run within 1e-10 of it, its float32 kernel
plan (the windows through the kernel's plain version) within 1e-6. A host-only test plans the three circuits at n = 32 with the
H100's admission and allocates no state."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

import rustqip_tpu.algos as ref_algos  # noqa: E402
from rustqip_tpu.prelude import LocalBuilder as RefBuilder  # noqa: E402

import rustqip_tpu_torch.algos as algos  # noqa: E402
from rustqip_tpu_torch import types as port_types  # noqa: E402
from rustqip_tpu_torch.engine import compile as port_compile  # noqa: E402
from rustqip_tpu_torch.engine.admission import HOPPER  # noqa: E402
from rustqip_tpu_torch.engine.apply import _swap_schedule  # noqa: E402
from rustqip_tpu_torch.engine.compile import MeasureEntry  # noqa: E402
from rustqip_tpu_torch.ops.matrix_ops import ReflectionOp, SwapOp  # noqa: E402
from rustqip_tpu_torch.prelude import LocalBuilder  # noqa: E402

torch.set_num_threads(1)  # the test runner keeps one worker per core busy

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

N = 12
MARKED = 0b101100111001
TOL = {"f64": 1e-10, "f32": 1e-6}
DTYPES = [("f64", None), ("f32", True)]  # (dtype, kernel_ok) of the port
IDS = ["f64", "f32_kernel_plan"]


@pytest.fixture(autouse=True)
def small_blocks(monkeypatch):
    monkeypatch.setattr(port_types, "PASS_BLOCK", 1 << 9)


def _qft(b, n):
    pkg = ref_algos if isinstance(b, RefBuilder) else algos
    pkg.qfft(b, b.register(n))


def _grover(b, n):
    pkg = ref_algos if isinstance(b, RefBuilder) else algos
    pkg.grover_iteration(b, b.h(b.register(n)), MARKED, native_diffusion=True)


def _runs(build, dtype, kernel_ok, init=0, forced=None):
    """(port planes, port results, JAX planes, JAX results) of one circuit;
    the JAX package runs it in float64 whatever the port's dtype."""
    ref = RefBuilder(dtype="f64")
    build(ref)
    rr, ri, rres = ref.compile().run(init, key=jax.random.PRNGKey(0), forced=forced)
    b = LocalBuilder(dtype=dtype, device="cpu", kernel_ok=kernel_ok)
    build(b)
    gen = torch.Generator().manual_seed(0)
    pr, pi, pres = b.compile().run(init, generator=gen, forced=forced)
    return (pr, pi), pres, (np.asarray(rr), np.asarray(ri)), rres


def _diff(port, ref):
    return max(np.abs(p.numpy().reshape(-1) - r.reshape(-1)).max() for p, r in zip(port, ref))


@pytest.mark.parametrize("outcome", [0, 5, 15])
@pytest.mark.parametrize("dtype, kernel_ok", DTYPES, ids=IDS)
def test_capacity_circuit_matches_reference(dtype, kernel_ok, outcome):
    port, pres, ref, rres = _runs(lambda b: chip_smoke.capacity_circuit(b, N), dtype,
                                  kernel_ok, forced={0: outcome})
    assert _diff(port, ref) <= TOL[dtype]
    assert pres[0][0] == int(rres[0][0]) == outcome
    assert abs(pres[0][1] - float(rres[0][1])) <= TOL[dtype]
    probs = pres[1].numpy()
    assert np.abs(probs - np.asarray(rres[1])).max() <= TOL[dtype]
    assert abs(probs[outcome] - 1) <= TOL[dtype]


@pytest.mark.parametrize("seed", [1, 2])
def test_capacity_circuit_bench_checks(seed):
    """The JAX bench's own checks on a seeded draw: the drawn outcome had
    probability 1/16 within 5 %, and the post-collapse distribution peaks
    there at 1 and sums to 1 within 1e-3."""
    b = LocalBuilder(dtype="f32", device="cpu", kernel_ok=True)
    chip_smoke.capacity_circuit(b, N)
    _, _, ((outcome, prob), probs) = b.compile().run(
        0, generator=torch.Generator().manual_seed(seed))
    p = probs.double()
    assert abs(prob - 1 / 16) < 0.05 / 16 and int(p.argmax()) == outcome
    assert abs(float(p[outcome]) - 1) < 1e-3 and abs(float(p.sum()) - 1) < 1e-3


@pytest.mark.parametrize("dtype, kernel_ok", DTYPES, ids=IDS)
def test_qft_all_ones_matches_reference(dtype, kernel_ok):
    init = (1 << N) - 1
    port, _, ref, _ = _runs(lambda b: _qft(b, N), dtype, kernel_ok, init=init)
    assert _diff(port, ref) <= TOL[dtype]
    assert chip_smoke.qft_closed_err([port[0]], [port[1]], N, init) <= TOL[dtype]


@pytest.mark.parametrize("dtype, kernel_ok", DTYPES, ids=IDS)
def test_grover_native_matches_reference(dtype, kernel_ok):
    port, _, ref, _ = _runs(lambda b: _grover(b, N), dtype, kernel_ok)
    assert _diff(port, ref) <= TOL[dtype]
    idx = sum(((MARKED >> j) & 1) << (N - 1 - j) for j in range(N))
    assert chip_smoke.grover_closed_err(port[0], port[1], N, idx) <= TOL[dtype]


def test_run_owns_its_planes():
    """``run`` updates only planes it made: a real float64
    ``initial_state`` (whose real part torch could share) is copied in and
    left as it was, although the reflections (the first sweep of the run)
    and the swap pass run in place; the norm check sums by block and
    records no drift."""
    v = np.random.default_rng(4).normal(size=1 << N)
    v /= np.linalg.norm(v)
    keep = v.copy()
    b = LocalBuilder(dtype="f64", device="cpu", check_norm=True)
    r = b.apply_reflection(b.register(N))
    r = algos.qfft(b, r)
    b.apply_reflection(r)
    cc = b.compile()
    before = list(port_compile.NORM_VIOLATIONS)
    re, im, _ = cc.run(initial_state=v)
    assert np.array_equal(v, keep)
    assert port_compile.NORM_VIOLATIONS == before
    ref = RefBuilder(dtype="f64")
    rr = ref.apply_reflection(ref.register(N))
    rr = ref_algos.qfft(ref, rr)
    ref.apply_reflection(rr)
    wr, wi, _ = ref.compile().run(initial_state=v)
    assert _diff((re, im), (np.asarray(wr), np.asarray(wi))) <= TOL["f64"]


def test_plan_at_32_qubits_on_the_h100(monkeypatch):
    """Host only: the three circuits of ``phase_capacity`` planned at
    n = 32 with the H100's admission are kernel windows but for one plain
    sweep each in QFT-32 (its swap pass: 7 cross pairs, 9 row pairs) and
    Grover-32 (the full reflection); no plain window, no dense pass. The
    window kinds are those of n = 28, with one more h = 4 window for every
    layer of H on the four extra row qubits."""
    monkeypatch.setattr(port_compile, "for_device", lambda device: HOPPER)
    monkeypatch.setattr(port_compile, "_CACHE", {})
    plans = {}
    for n in (28, 32):
        for name, build, counts in (
            ("capacity", lambda b: chip_smoke.capacity_circuit(b, n), (5, 0)),
            ("qft", lambda b: _qft(b, n), (6, 1)),
            ("grover", lambda b: algos.grover_iteration(
                b, b.h(b.register(n)), chip_smoke.CAP_MARKED, native_diffusion=True), (10, 1)),
        ):
            b = LocalBuilder(dtype="f32", device="cpu", kernel_ok=True)
            build(b)
            cc = b.compile()
            extra = (n - 28) // 4 * (2 if name == "grover" else 1)
            assert cc.sweep_counts() == {"kwindow": counts[0] + extra, "window": 0,
                                         "op": counts[1]}
            ops = [p for s in cc.sweeps if not isinstance(s, MeasureEntry)
                   for kind, p, _ in s if kind == "op"]
            kinds = {st[0] for s in cc.sweeps if not isinstance(s, MeasureEntry)
                     for kind, p, _ in s if kind == "kwindow" for st in p[1]}
            plans[name, n] = kinds
            if name == "qft":
                (op,) = ops
                cross, rowp, colp, mixed = _swap_schedule(n, op)
                assert isinstance(op, SwapOp) and not colp and not mixed
                assert (len(cross), len(rowp)) == (7, (n - 14) // 2)
            if name == "grover":
                (op,) = ops
                assert isinstance(op, ReflectionOp) and op.indices == tuple(range(n))
    for name in ("capacity", "qft", "grover"):
        assert plans[name, 28] == plans[name, 32]
