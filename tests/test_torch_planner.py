"""Plan equality: the port's planner under ``TpuReferenceAdmission``
against the JAX package's planner on its kernel path, entry by entry —
``plan_sweeps``, ``window_ksteps``, ``window_strip_activity`` and the
fused segments of ``CompiledCircuit._plan``. Host-only: no state is
touched.

Cases: the ten kernel parity windows at n=20 (``scripts/kernel_parity.py``
and the port's ``engine/parity_windows.py``), QFT-16, one Grover-16
iteration (gate form and native diffusion) and bench.py's two arms at
n=16."""

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

from rustqip_tpu.engine import pallas_kernels as ref_pk  # noqa: E402
from rustqip_tpu.engine import real_apply as ref_ra  # noqa: E402

from rustqip_tpu_torch.engine import real_apply as port_ra  # noqa: E402
from rustqip_tpu_torch.engine import window_kernel as port_wk  # noqa: E402
from rustqip_tpu_torch.engine.admission import (  # noqa: E402
    TpuReferenceAdmission,
    window_seg_sizes,
)
from rustqip_tpu_torch.engine.parity_windows import build_sequences  # noqa: E402
from rustqip_tpu_torch.interop import ops_from_reference  # noqa: E402
from rustqip_tpu_torch.ops.matrix_ops import op_fingerprint, op_to_dense  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _ref_parity_sequences(n):
    """The JAX package's own parity windows (scripts/kernel_parity.py);
    importing it sets RUSTQIP_TPU_PALLAS, which is restored."""
    saved = os.environ.get("RUSTQIP_TPU_PALLAS")
    spec = importlib.util.spec_from_file_location(
        "_kernel_parity", ROOT / "scripts" / "kernel_parity.py"
    )
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        if saved is None:
            os.environ.pop("RUSTQIP_TPU_PALLAS", None)
        else:
            os.environ["RUSTQIP_TPU_PALLAS"] = saved
    return mod.build_sequences(n)


def _same(a, b, path="") -> None:
    """Structural equality of plan payloads across the two packages:
    tuples/lists/dicts recursively, floats to 1e-12, ops by matrix."""
    if type(a).__name__ in ("DenseOp", "SparseOp", "SwapOp", "ControlOp",
                            "PhaseProductOp", "ReflectionOp"):
        assert type(a).__name__ == type(b).__name__, path
        assert tuple(a.indices) == tuple(b.indices), path
        if type(a).__name__ == "DenseOp":
            np.testing.assert_allclose(op_to_dense(b), _ref_dense(a), atol=1e-12)
        else:  # never densify: a 16-qubit swap is 64 GiB dense
            assert op_fingerprint(b) == op_fingerprint(ops_from_reference([a])[0])
        return
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
        return
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
        return
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=0, atol=1e-12)
        return
    if isinstance(a, (float, complex)) or isinstance(b, (float, complex)):
        assert abs(complex(a) - complex(b)) <= 1e-12, (path, a, b)
        return
    assert a == b, (path, a, b)


def _ref_dense(op):
    from rustqip_tpu.ops.matrix_ops import op_to_dense as rd

    return rd(op)


def _check_plans(n, ref_ops):
    port_ops = ops_from_reference(ref_ops)
    ref_plan = ref_ra.plan_sweeps(n, ref_ops, kernel_ok=True)
    port_plan = port_ra.plan_sweeps(
        n, port_ops, kernel_ok=True, admission=TpuReferenceAdmission()
    )
    assert [k for k, _, _ in port_plan] == [k for k, _, _ in ref_plan]
    for (rk, rp, rrun), (pk, pp, prun) in zip(ref_plan, port_plan):
        assert [op_fingerprint(o) for o in prun] == [
            op_fingerprint(o) for o in ops_from_reference(rrun)
        ]
        if rk == "op":
            _same(rp, pp)
            continue
        rhq, rsteps = rp
        phq, psteps = pp
        assert tuple(phq) == tuple(rhq)
        _same(rsteps, psteps)
        if rk != "kwindow":
            continue
        rks = ref_ra.window_ksteps(n, rhq, rsteps)
        pks = port_ra.window_ksteps(n, phq, psteps)
        _same(rks, pks)
        seg = ref_ra._window_seg_sizes(n, rhq)
        assert tuple(window_seg_sizes(n, phq)) == tuple(seg)
        assert port_wk.window_strip_activity(n, seg, pks) == (
            ref_pk.window_strip_activity(n, seg, rks)
        )
        rbody, rmats = ref_pk._window_matrix_operands(rks)
        pbody, pmats = port_wk._window_matrix_operands(pks)
        _same(rbody, pbody)
        _same(rmats, pmats)
    return port_plan


PARITY_NAMES = [s[0] for s in build_sequences(20)]


@pytest.mark.parametrize("name", PARITY_NAMES)
def test_parity_window_plans_like_reference(name):
    n = 20
    ref_seqs = {s[0]: s for s in _ref_parity_sequences(n)}
    port_seqs = {s[0]: s for s in build_sequences(n)}
    assert sorted(ref_seqs) == sorted(port_seqs)
    _, rops, expected = ref_seqs[name]
    _, pops, _ = port_seqs[name]
    # the port's own parity windows are the reference's, op for op
    assert [op_fingerprint(o) for o in pops] == [
        op_fingerprint(o) for o in ops_from_reference(rops)
    ]
    plan = _check_plans(n, rops)
    kinds = {s[0] for k, p, _ in plan if k == "kwindow" for s in p[1]}
    assert all(k == "kwindow" for k, _, _ in plan)
    assert expected <= kinds


@pytest.mark.parametrize("name", PARITY_NAMES)
def test_parity_windows_fit_hopper_tiles(name):
    """Under the Hopper admission every parity window still rides the
    kernel, and every rbf partner row lies inside the CTA's tile."""
    from rustqip_tpu_torch.engine.admission import HopperSmemAdmission

    n = 20
    ops = dict((s[0], s[1]) for s in build_sequences(n))[name]
    sweeps = port_ra.compile_sweeps(n, ops, True, HopperSmemAdmission())
    assert sweeps and all(k == "kwindow" for k, _, _ in sweeps)
    for _, (seg, ksteps, prog), _ in sweeps:
        assert prog.bt >= HopperSmemAdmission.MIN_TILE_ROWS
        assert (1 << (prog.max_rbf_bit + 1)) <= prog.bt
        tile = (1 << prog.h) * prog.bt * 1024 * (2 if prog.scratch else 1)
        assert tile <= 232448 - 256


def _ref_circuit(build, n):
    """(reference CompiledCircuit, port CompiledCircuit) of one circuit, the
    reference on its kernel path (``available`` patched, as the JAX
    package's own tests do) and the port with kernel_ok on the CPU."""
    from rustqip_tpu.prelude import LocalBuilder as RB

    from rustqip_tpu_torch.prelude import LocalBuilder as PB

    rb = RB(dtype="f32")
    build(rb, "ref")
    pb = PB(dtype="f32", device="cpu", kernel_ok=True)
    build(pb, "port")
    return rb.compile(), pb.compile()


def _qft(n):
    def build(b, side):
        if side == "ref":
            from rustqip_tpu.algos import qfft
        else:
            from rustqip_tpu_torch.algos import qfft
        qfft(b, b.register(n))

    return build


def _grover(n, native):
    def build(b, side):
        if side == "ref":
            from rustqip_tpu.algos.grover import grover_iteration
        else:
            from rustqip_tpu_torch.algos.grover import grover_iteration
        r = b.h(b.register(n))
        grover_iteration(b, r, 0b1011001110101 & ((1 << n) - 1),
                         native_diffusion=native)

    return build


@pytest.mark.parametrize(
    "name,build",
    [("qft16", _qft(16)), ("grover16", _grover(16, False)),
     ("grover16_native", _grover(16, True))],
)
def test_circuit_segments_and_plans_like_reference(monkeypatch, name, build):
    monkeypatch.setattr(ref_pk, "available", lambda: True)
    n = 16
    rcc, pcc = _ref_circuit(build, n)
    assert rcc._kernel_ok and pcc._kernel_ok
    assert len(pcc.segments) == len(rcc.segments)
    for rs, ps in zip(rcc.segments, pcc.segments):
        if isinstance(rs, tuple) or not isinstance(rs, list):
            _same(rs if not isinstance(rs, tuple) else rs[:2],
                  ps if not isinstance(ps, tuple) else ps[:2])
            if not isinstance(rs, tuple):
                continue
            rs, ps = rs[2], ps[2]
        assert [op_fingerprint(o) for o in ps] == [
            op_fingerprint(o) for o in ops_from_reference(rs)
        ]
        _check_plans(n, rs)


def test_bench_arms_plan_like_reference():
    spec = importlib.util.spec_from_file_location("_bench", ROOT / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    n = 16
    fused, unfused = bench._build_ops(n, 30, 20)
    for ops in (fused, unfused):
        _check_plans(n, ops)
