"""The port's sharded executors (``parallel/explicit.py``, ``sharded.py``)
against the JAX package, on meshes of D = 2, 4 and 8 entries of ``"cpu"``:
twins of ``tests/test_sharded.py``, ``test_explicit_executor.py`` and
``test_coverage_extras.py`` (:11, :38, :121) held against the JAX package's
single-device run of the same circuit (1e-10 in float64, 1e-5 in float32),
collapse parity through forced outcomes, and three direct runs of the JAX
package's explicit executor on its 8-device mesh (a stochastic measurement,
a repeat block, a forced collapse). Also ``check_norm`` on the single-device
and sharded compilers."""

import warnings

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

import rustqip_tpu.algos as ref_algos  # noqa: E402
from rustqip_tpu.builder.builder import _lower_item as ref_lower  # noqa: E402
from rustqip_tpu.parallel import make_shard_mesh as ref_mesh  # noqa: E402
from rustqip_tpu.parallel.explicit import compile_sharded_explicit as ref_explicit  # noqa: E402
from rustqip_tpu.parallel.sharded import sharded_calculate_state as ref_sharded  # noqa: E402
from rustqip_tpu.prelude import LocalBuilder as RefBuilder  # noqa: E402

import rustqip_tpu_torch.algos as algos  # noqa: E402
import rustqip_tpu_torch.parallel.explicit as explicit_mod  # noqa: E402
import rustqip_tpu_torch.parallel.sharded as sharded_mod  # noqa: E402
from rustqip_tpu_torch.builder.builder import _lower_item  # noqa: E402
from rustqip_tpu_torch.engine import compile as engine_compile  # noqa: E402
from rustqip_tpu_torch.parallel import (  # noqa: E402
    compile_sharded,
    compile_sharded_explicit,
    make_multislice_mesh,
    make_shard_mesh,
    sharded_calculate_state,
)
from rustqip_tpu_torch.interop import planes_from_numpy  # noqa: E402
from rustqip_tpu_torch.parallel.explicit import (  # noqa: E402
    gather_state,
    sharded_measure_probs_ri,
    sharded_measure_state_ri,
)
from rustqip_tpu_torch.prelude import LocalBuilder  # noqa: E402

torch.set_num_threads(1)  # the test runner keeps one worker per core busy


def _mesh(d):
    return make_shard_mesh(d, devices=["cpu"] * d)


def _port(dtype="f64", **kw):
    return LocalBuilder(dtype=dtype, device="cpu", **kw)


def _entries(b, lower=_lower_item):
    return [e for item in b.pipeline for e in lower(item)]


def _mixed(b, qfft):
    """Gates on global qubits, local qubits and across the seam
    (tests/test_sharded.py:build_mixed_circuit), then a QFT."""
    qs = b.split_all_register(b.register(10))
    qs[0] = b.h(qs[0])
    qs[1] = b.h(qs[1])
    qs[9] = b.h(qs[9])
    qs[0], qs[9] = b.cnot(qs[0], qs[9])
    qs[9], qs[1] = b.cnot(qs[9], qs[1])
    qs[2], qs[8] = b.swap(qs[2], qs[8])
    qs[1] = b.t(qs[1])
    qs[4] = b.rz(qs[4], 0.37)
    return b.measure_stochastic(qfft(b, b.merge_registers(qs)))[1]


@pytest.mark.parametrize("strategy", ["explicit", "gspmd"])
def test_mixed_circuit_matches_jax_single_device(strategy):
    rb = RefBuilder(dtype="f64")
    rh = _mixed(rb, ref_algos.qfft)
    want, rm = rb.calculate_state(seed=0)
    for d in (2, 4, 8):
        b = _port()
        h = _mixed(b, algos.qfft)
        re, im, m = sharded_calculate_state(b, mesh=_mesh(d), seed=0, strategy=strategy)
        np.testing.assert_allclose(gather_state(re, im), np.asarray(want), atol=1e-10, rtol=0)
        np.testing.assert_allclose(m.get_stochastic_measurement(h),
                                   rm.get_stochastic_measurement(rh), atol=1e-10, rtol=0)
        assert len(re) == d and all(r.device.type == "cpu" for r in re)


def test_grover_and_qft_distributions_f32():
    for name, build in (
        ("grover", lambda b, a: a.grover_search(b, 5, 0b10110)[1]),
        ("qft", lambda b, a: b.measure_stochastic(a.qfft(b, b.h(b.register(6))))[1]),
    ):
        rb = RefBuilder(dtype="f32")
        rh = build(rb, ref_algos)
        _, rm = rb.calculate_state(seed=1)
        for d in (2, 8):
            b = _port("f32")
            h = build(b, algos)
            _, _, m = sharded_calculate_state(b, mesh=_mesh(d), seed=1)
            np.testing.assert_allclose(m.get_stochastic_measurement(h),
                                       rm.get_stochastic_measurement(rh), atol=1e-5, rtol=0)


def test_collapse_is_normalized_with_its_probability():
    for strategy in ("explicit", "gspmd"):
        b = _port()
        r, h = b.measure(b.h(b.register(5)))
        re, im, m = sharded_calculate_state(b, mesh=_mesh(8), seed=9, strategy=strategy)
        out, p = m.get_measurement(h)
        assert 0 <= out < 32 and abs(p - 1 / 32) < 1e-10
        state = gather_state(re, im)
        assert abs(np.linalg.norm(state) - 1) < 1e-10
        assert abs(abs(state[int(''.join(str((out >> j) & 1) for j in range(5)), 2)]) - 1) < 1e-10


def test_multislice_mesh_runs_the_kernel_off_schedule():
    def build(b, a):
        qs = b.split_all_register(b.register(7))
        qs[0] = b.h(qs[0])
        qs[0], qs[-1] = b.cnot(qs[0], qs[-1])
        return b.measure_stochastic(a.qfft(b, b.merge_registers(qs)))[1]

    rb = RefBuilder(dtype="f64")
    rh = build(rb, ref_algos)
    want, rm = rb.calculate_state(seed=0)
    b = _port()
    h = build(b, algos)
    mesh = make_multislice_mesh(2, 4, devices=["cpu"] * 8)
    assert mesh.axis_names == ("dcn", "shard")
    re, im, m = sharded_calculate_state(b, mesh=mesh, seed=0)
    assert len(re) == 8
    np.testing.assert_allclose(gather_state(re, im), np.asarray(want), atol=1e-10, rtol=0)
    np.testing.assert_allclose(m.get_stochastic_measurement(h),
                               rm.get_stochastic_measurement(rh), atol=1e-10, rtol=0)


def test_auto_routes_explicit_on_1d_and_gspmd_on_2d(monkeypatch):
    calls = []
    real_explicit = explicit_mod.compile_sharded_explicit
    real_gspmd = sharded_mod.compile_sharded
    monkeypatch.setattr(explicit_mod, "compile_sharded_explicit",
                        lambda *a, **k: calls.append("explicit") or real_explicit(*a, **k))
    monkeypatch.setattr(sharded_mod, "compile_sharded",
                        lambda *a, **k: calls.append("gspmd") or real_gspmd(*a, **k))

    def build(b):
        return b.measure_stochastic(b.h(b.register(5)))[1]

    b1 = _port("f32")
    h1 = build(b1)
    _, _, m1 = sharded_calculate_state(b1, mesh=_mesh(8), seed=0)
    assert calls == ["explicit"]
    b2 = _port("f32")
    h2 = build(b2)
    _, _, m2 = sharded_calculate_state(
        b2, mesh=make_multislice_mesh(2, 4, devices=["cpu"] * 8), seed=0)
    assert calls == ["explicit", "gspmd"]
    np.testing.assert_allclose(m1.get_stochastic_measurement(h1),
                               m2.get_stochastic_measurement(h2), atol=1e-10, rtol=0)
    with pytest.raises(Exception, match="Unknown sharding strategy"):
        sharded_calculate_state(b2, mesh=_mesh(2), seed=0, strategy="nccl")


def test_kernel_policy_explicit_on_gspmd_off():
    """The gspmd counterpart never plans a kernel window (plain greedy
    fusion); the explicit executor with ``kernel_ok`` plans them in the
    shard-local space and, through the kernel's plain version here, matches
    the JAX package's single-device run (an n = 16 ripple adder)."""
    def build(b, a):
        rc, ra, rb = b.register(5), b.register(5), b.register(6)
        ra = b.h(ra)
        a.add(b, rc, ra, rb)
        return [(rb, 9)]

    rb_ = RefBuilder(dtype="f32")
    it = build(rb_, ref_algos)
    want, _ = rb_.calculate_state_with_init(it, seed=0)
    b = _port("f32", kernel_ok=True)
    it = build(b, algos)
    mesh = _mesh(8)
    cg = compile_sharded(b.n, _entries(b), b.dtype, mesh)
    assert not cg._kernel_ok and cg.sweep_counts()["kwindow"] == 0
    ce = compile_sharded_explicit(b.n, _entries(b), b.dtype, mesh, kernel_ok=True)
    assert ce._kernel_ok and ce.sweep_counts()["kwindow"] > 0
    assert compile_sharded_explicit(b.n, _entries(b), b.dtype, mesh)._kernel_ok is False
    re, im, _ = sharded_calculate_state(b, it, mesh=mesh, seed=0)
    np.testing.assert_allclose(gather_state(re, im), np.asarray(want), atol=1e-5, rtol=0)


def test_measure_functions_match_jax_single_device():
    """``sharded_measure_probs_ri`` (shard-local reductions summed over the
    shards) and ``sharded_measure_state_ri`` (the collapse, no exchange)
    against the JAX package's single-device functions, for global, local
    and mixed measured qubits in any order."""
    from rustqip_tpu.ops.measurement_ops import measure_probs, measure_state

    n = 9
    rng = np.random.default_rng(12)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    v /= np.linalg.norm(v)
    for d in (2, 8):
        mesh = _mesh(d)
        planes = [planes_from_numpy(c, torch.float64, device="cpu") for c in np.split(v, d)]
        re, im = [p[0] for p in planes], [p[1] for p in planes]
        for idx in ((0,), (n - 1, 0), (2, 5, 1, 8), (4, 6)):
            probs = sharded_measure_probs_ri(mesh, n, idx, re, im)
            want = np.asarray(measure_probs(n, idx, v))
            np.testing.assert_allclose(probs.numpy(), want, atol=1e-12, rtol=0)
            outcome = int(np.argmax(want))
            cr, ci = sharded_measure_state_ri(mesh, n, idx, (outcome, float(want[outcome])),
                                              re, im)
            np.testing.assert_allclose(
                gather_state(cr, ci),
                np.asarray(measure_state(n, idx, (outcome, want[outcome]), v)), atol=1e-12)


def _lowered(build, dtype="f64"):
    b = _port(dtype)
    build(b)
    return b, _entries(b)


def test_check_norm_plumbs_and_fingerprints():
    """``check_norm`` reaches both sharded compilers and the single-device
    one, and joins each cache key (a norm-on request is never served a
    cached norm-off circuit). No environment variable is read."""
    b, entries = _lowered(lambda b: b.h(b.register(4)))
    mesh = _mesh(8)
    for compiler in (compile_sharded, compile_sharded_explicit):
        off = compiler(b.n, entries, np.complex128, mesh, check_norm=False)
        on = compiler(b.n, entries, np.complex128, mesh, check_norm=True)
        assert off is not on and off._check_norm is False and on._check_norm is True
        assert compiler(b.n, entries, np.complex128, mesh) is off
    off = engine_compile.compile_pipeline(b.n, entries, np.complex128, device="cpu")
    on = engine_compile.compile_pipeline(b.n, entries, np.complex128, device="cpu",
                                         check_norm=True)
    assert off is not on and not off._check_norm and on._check_norm
    assert LocalBuilder(device="cpu", check_norm=True).new_similar()._check_norm


def test_norm_check_warns_on_a_projector():
    """A projector halves |psi|^2: with ``check_norm`` each executor warns
    once and records the segment; without it nothing is recorded."""
    def build(b):
        q3 = b.split_all_register(b.register(7))[3]
        q3 = b.h(q3)
        b.apply_matrix(q3, np.diag([1.0, 0.0]))

    b, entries = _lowered(build)
    runs = [
        lambda on: engine_compile.compile_pipeline(
            7, entries, np.complex128, device="cpu", check_norm=on).run(0),
        lambda on: compile_sharded_explicit(7, entries, np.complex128, _mesh(8),
                                            check_norm=on).run(0),
        lambda on: compile_sharded(7, entries, np.complex128, _mesh(4), check_norm=on).run(0),
    ]
    for run in runs:
        engine_compile.NORM_VIOLATIONS.clear()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run(False)
        assert not engine_compile.NORM_VIOLATIONS and not caught
        with pytest.warns(RuntimeWarning, match="norm drift after segment 0"):
            run(True)
        assert len(engine_compile.NORM_VIOLATIONS) == 1
        assert abs(engine_compile.NORM_VIOLATIONS[0][1] - 0.5) < 1e-12


def _forced_circuit(b):
    qs = b.split_all_register(b.register(7))
    qs[0] = b.h(qs[0])                          # global qubit
    qs[0], qs[-1] = b.cnot(qs[0], qs[-1])       # global -> local
    qs[1], qs[-2] = b.swap(qs[1], qs[-2])       # across the seam
    qs[2] = b.t(qs[2])
    qs[4] = b.h(qs[4])
    r = b.merge_registers(qs)
    qs = b.split_all_register(r)
    _, m0 = b.measure(b.merge_registers(qs[:3]))    # global qubits
    _, m1 = b.measure(b.merge_registers(qs[3:]))    # local qubits
    return m0, m1


def test_forced_collapse_matches_jax_single_device():
    """Collapse parity through forcing (``conditions=`` on the JAX side,
    ``forced=`` on the compiled sharded circuits): outcome, probability and
    the collapsed state, global and local measurements."""
    rb = RefBuilder(dtype="f64")
    m0, m1 = _forced_circuit(rb)
    conditions = {m0: 0b001, m1: 0b1001}
    want, rm = rb.calculate_state_with_init(conditions=conditions, seed=0)
    forced = {0: 0b001, 1: 0b1001}
    for d in (2, 4, 8):
        b = _port()
        _forced_circuit(b)
        for compiler in (compile_sharded_explicit, compile_sharded):
            cc = compiler(7, _entries(b), b.dtype, _mesh(d))
            re, im, res = cc.run(0, forced=forced)
            for (o, p), h in zip(res, (m0, m1)):
                ro, rp = rm.get_measurement(h)
                assert o == ro and abs(p - rp) < 1e-10
            np.testing.assert_allclose(gather_state(re, im), np.asarray(want), atol=1e-10,
                                       rtol=0)
            state, _ = cc.run_complex(0, forced=forced)
            np.testing.assert_allclose(state, np.asarray(want), atol=1e-10, rtol=0)


def test_forced_probability_override():
    """A forced ``(outcome, prob)`` rescales by the given probability."""
    b = _port()
    q = b.h(b.split_all_register(b.register(7))[0])
    b.measure(q)
    cc = compile_sharded_explicit(7, _entries(b), b.dtype, _mesh(8))
    re, im, res = cc.run(0, forced={0: (1, 0.25)})
    assert res[0] == (1, 0.25)
    assert abs(np.linalg.norm(gather_state(re, im)) ** 2 - 2.0) < 1e-10


def test_initial_state_matches_single_device():
    b = _port()
    b.h(b.register(7))
    entries = _entries(b)
    rng = np.random.default_rng(3)
    init = rng.normal(size=128) + 1j * rng.normal(size=128)
    init /= np.linalg.norm(init)
    rb = RefBuilder(dtype="f64")
    rb.h(rb.register(7))
    want, _ = rb.compile().run_complex(initial_state=init, key=jax.random.PRNGKey(0))
    for d in (2, 8):
        cc = compile_sharded_explicit(7, entries, np.complex128, _mesh(d))
        state, _ = cc.run_complex(initial_state=init)
        np.testing.assert_allclose(state, np.asarray(want), atol=1e-10, rtol=0)


def _repeat_circuit(b, times):
    r = b.h(b.register(6))

    def round_(bb, reg):
        regs = bb.split_all_register(reg)
        regs[0] = bb.t(regs[0])              # global qubit phase
        regs[0] = bb.h(regs[0])              # global: exchange
        regs[-1] = bb.h(regs[-1])            # local lane op
        regs[0], regs[-1] = bb.cnot(regs[0], regs[-1])
        return bb.merge_registers(regs)

    return b.measure_stochastic(b.repeat(times, round_, r))[1]


def test_repeat_blocks_match_jax_single_device():
    for times in (3, 200):
        rb = RefBuilder(dtype="f32")
        rh = _repeat_circuit(rb, times)
        _, rm = rb.calculate_state(seed=1)
        b = _port("f32")
        h = _repeat_circuit(b, times)
        _, _, m = sharded_calculate_state(b, mesh=_mesh(8), seed=1, strategy="explicit")
        np.testing.assert_allclose(m.get_stochastic_measurement(h),
                                   rm.get_stochastic_measurement(rh),
                                   atol=1e-5 if times == 3 else 1e-4, rtol=0)


# Direct runs of the JAX package's explicit executor on its 8-device mesh.

def test_jax_explicit_distribution_equals_port():
    def build(b, a):
        qs = b.split_all_register(b.register(7))
        qs[0] = b.h(qs[0])
        qs[0], qs[-1] = b.cnot(qs[0], qs[-1])
        qs[1], qs[-2] = b.swap(qs[1], qs[-2])
        qs[2] = b.t(qs[2])
        return b.measure_stochastic(a.qfft(b, b.merge_registers(qs)))[1]

    rb = RefBuilder(dtype="f64")
    rh = build(rb, ref_algos)
    _, _, rm = ref_sharded(rb, mesh=ref_mesh(8), seed=0, strategy="explicit")
    b = _port()
    h = build(b, algos)
    _, _, m = sharded_calculate_state(b, mesh=_mesh(8), seed=0, strategy="explicit")
    np.testing.assert_allclose(m.get_stochastic_measurement(h),
                               np.asarray(rm.get_stochastic_measurement(rh)), atol=1e-10,
                               rtol=0)


def test_jax_explicit_repeat_block_equals_port():
    rb = RefBuilder(dtype="f64")
    rh = _repeat_circuit(rb, 5)
    rre, rim, rm = ref_sharded(rb, mesh=ref_mesh(8), seed=1, strategy="explicit")
    b = _port()
    h = _repeat_circuit(b, 5)
    re, im, m = sharded_calculate_state(b, mesh=_mesh(8), seed=1, strategy="explicit")
    want = np.asarray(rre) + 1j * np.asarray(rim)
    np.testing.assert_allclose(gather_state(re, im), want, atol=1e-10, rtol=0)
    np.testing.assert_allclose(m.get_stochastic_measurement(h),
                               np.asarray(rm.get_stochastic_measurement(rh)), atol=1e-10,
                               rtol=0)


def test_jax_explicit_forced_collapse_equals_port():
    rb = RefBuilder(dtype="f64")
    _forced_circuit(rb)
    rcc = ref_explicit(7, _entries(rb, ref_lower), np.complex128, ref_mesh(8))
    b = _port()
    _forced_circuit(b)
    cc = compile_sharded_explicit(7, _entries(b), np.complex128, _mesh(8))
    for forced in ({0: 0b101, 1: 0b0110}, {0: 0b000, 1: 0b1111}):
        rre, rim, rres = rcc.run(initial_index=0, key=jax.random.PRNGKey(0),
                                 forced={k: (v, None) for k, v in forced.items()})
        re, im, res = cc.run(0, forced=forced)
        for (o, p), (ro, rp) in zip(res, rres):
            assert o == int(ro) and abs(p - float(rp)) < 1e-10
        np.testing.assert_allclose(gather_state(re, im), np.asarray(rre) + 1j * np.asarray(rim),
                                   atol=1e-10, rtol=0)
