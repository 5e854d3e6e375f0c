"""Port twins of the JAX package's main-path families that had none:
``tests/test_midcircuit.py``, ``test_round2_fixes.py``,
``test_diagonal_fusion.py``, ``test_swap_fastpaths.py`` and
``test_reflection.py``. Each case runs the same circuit or ops through the
JAX package and the port on the CPU (float64, 1e-10 unless stated);
sampled outcomes are compared through forcing and distributions, since
torch cannot reproduce ``jax.random``."""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import rustqip_tpu.algos as ref_algos  # noqa: E402
from rustqip_tpu.engine import apply as ref_apply  # noqa: E402
from rustqip_tpu.engine.fusion import fuse_ops as ref_fuse  # noqa: E402
from rustqip_tpu.ops import gates  # noqa: E402
from rustqip_tpu.ops import matrix_ops as R  # noqa: E402
from rustqip_tpu.prelude import LocalBuilder as RefBuilder  # noqa: E402

import rustqip_tpu_torch.algos as algos  # noqa: E402
from rustqip_tpu_torch.builder.builder import _lower_item  # noqa: E402
from rustqip_tpu_torch.builder.circuit_objects import (  # noqa: E402
    CircuitObject,
    ControlledMatGate,
    ReflectionGate,
    invert_circuit_object,
)
from rustqip_tpu_torch.engine import apply as port_apply  # noqa: E402
from rustqip_tpu_torch.engine import real_apply as port_ra  # noqa: E402
from rustqip_tpu_torch.engine.admission import TPU_REFERENCE  # noqa: E402
from rustqip_tpu_torch.engine.fusion import fuse_ops  # noqa: E402
from rustqip_tpu_torch.errors import CircuitError  # noqa: E402
from rustqip_tpu_torch.interop import (  # noqa: E402
    op_from_reference,
    ops_from_reference,
    planes_from_numpy,
    planes_to_numpy,
)
from rustqip_tpu_torch.ops import matrix_ops as P  # noqa: E402
from rustqip_tpu_torch.ops.measurement_ops import MeasuredCondition  # noqa: E402
from rustqip_tpu_torch.parallel import (  # noqa: E402
    compile_sharded,
    compile_sharded_explicit,
    make_shard_mesh,
    sharded_calculate_state,
)
from rustqip_tpu_torch.parallel.explicit import gather_state  # noqa: E402
from rustqip_tpu_torch.prelude import LocalBuilder  # noqa: E402

torch.set_num_threads(1)  # the test runner keeps one worker per core busy


def _port(**kw):
    kw.setdefault("dtype", "f64")
    return LocalBuilder(device="cpu", **kw)


def _state(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return v / np.linalg.norm(v)


def _apply_port(n, ops, v):
    re, im = planes_from_numpy(v, torch.float64, device="cpu")
    for op in ops:
        re, im = port_ra.apply_op_ri(n, op, re, im)
    return planes_to_numpy(re, im)


def _apply_ref(n, ops, v):
    """The JAX package's result: its full op matrices up to 8 qubits (no
    jit compile per op), its engine's ``apply_op`` above."""
    for op in ops:
        v = R.make_op_matrix(n, op) @ v if n <= 8 else np.asarray(ref_apply.apply_op(n, op, v))
    return v


# -- tests/test_midcircuit.py ----------------------------------------------

def test_gates_after_a_collapse_and_sequential_measurements():
    """H; measure; H: the post-collapse state is a basis state, so the last
    distribution is uniform; a second measurement repeats the first."""
    for seed in range(4):
        b = _port()
        q = b.h(b.qubit())
        q, m = b.measure(q)
        q, m2 = b.measure(q)
        q, s = b.measure_stochastic(b.h(q))
        _, meas = b.calculate_state_with_init(seed=seed)
        (o1, p1), (o2, p2) = meas.get_measurement(m), meas.get_measurement(m2)
        assert abs(p1 - 0.5) < 1e-10 and o1 == o2 and abs(p2 - 1) < 1e-10
        np.testing.assert_allclose(meas.get_stochastic_measurement(s), [0.5, 0.5], atol=1e-10)


def test_collapse_propagates_to_the_partner_qubit():
    outcomes = set()
    for seed in range(8):
        b = _port()
        q0, q1 = b.qubit(), b.qubit()
        q0, q1 = b.cnot(b.h(q0), q1)
        q0, m0 = b.measure(q0)
        q1, s1 = b.measure_stochastic(q1)
        _, meas = b.calculate_state_with_init(seed=seed)
        out0, p0 = meas.get_measurement(m0)
        assert abs(p0 - 0.5) < 1e-10
        np.testing.assert_allclose(meas.get_stochastic_measurement(s1), np.eye(2)[out0],
                                   atol=1e-10)
        outcomes.add(out0)
    assert outcomes == {0, 1}


def test_sample_counts_and_forcing_match_jax():
    for builder in (_port(), RefBuilder(dtype="f64")):
        q = builder.h(builder.qubit())
        q, s = builder.measure_stochastic(q)
        _, meas = builder.calculate_state(seed=0)
        counts = meas.sample_counts(s, shots=10000, seed=1)
        assert set(counts) == {0, 1} and sum(counts.values()) == 10000
        assert abs(counts[0] - 5000) < 400
    for want in (0, 1):
        states = []
        for builder in (_port(), RefBuilder(dtype="f64")):
            q = builder.h(builder.qubit())
            q, m = builder.measure(q)
            state, meas = builder.calculate_state(seed=0, conditions={m: want})
            out, p = meas.get_measurement(m)
            assert out == want and abs(p - 0.5) < 1e-10
            states.append(np.asarray(state))
        np.testing.assert_allclose(states[0], states[1], atol=1e-12)
        np.testing.assert_allclose(np.abs(states[0]) ** 2, np.eye(2)[want], atol=1e-10)


# -- tests/test_round2_fixes.py ----------------------------------------------

def test_forced_prob_override_and_forms_agree():
    b = _port()
    q, m = b.measure(b.h(b.qubit()))
    state, meas = b.calculate_state(seed=0, conditions={m: MeasuredCondition(measured=1,
                                                                             prob=0.25)})
    assert meas.get_measurement(m) == (1, 0.25)
    np.testing.assert_allclose(np.abs(state), [0.0, np.sqrt(2.0)], atol=1e-10)
    s1, _ = b.calculate_state(seed=0, conditions={m: 1})
    s2, _ = b.calculate_state(seed=0, conditions={m: (1, None)})
    np.testing.assert_allclose(s1, s2, atol=1e-12)


def test_forced_with_an_explicit_initial_state():
    b = _port()
    b.measure(b.h(b.qubit()))
    re, im, res = b.compile().run(initial_state=np.array([0.6, 0.8], dtype=np.complex128),
                                  forced={0: (0, None)})
    outcome, prob = res[0]
    assert outcome == 0 and abs(prob - 0.98) < 1e-10
    np.testing.assert_allclose(np.abs(planes_to_numpy(re, im)), [1.0, 0.0], atol=1e-7)


def test_invalid_forcing_split_and_index_raise():
    b = _port()
    q, s = b.measure_stochastic(b.h(b.qubit()))
    for cond in ({s: 1}, {0: 1}, {5: 1}):
        with pytest.raises(CircuitError):
            b.calculate_state(seed=0, conditions=cond)
    b = _port()
    with pytest.raises(CircuitError):
        b.split_register_relative(b.register(3), [0, 3])
    with pytest.raises(CircuitError):
        b.split_register_relative(b.register(3), [1, 1])
    b = _port()
    b.h(b.qubit())
    cc = b.compile()
    for bad in (2, -1):
        with pytest.raises(CircuitError):
            cc.run(initial_index=bad)


def test_initial_index_row_col_split():
    b = _port()
    b.measure_stochastic(b.register(9))  # n = 9: C = 128, R = 4
    cc = b.compile()
    for idx in (0, 1, 127, 128, 300, 511):
        re, im, _ = cc.run(initial_index=idx)
        assert int(np.argmax(np.abs(planes_to_numpy(re, im)))) == idx


@pytest.mark.parametrize("n", [3, 8])
def test_phase_product_nonunit_magnitude_exact(n):
    rng = np.random.default_rng(5)
    d1 = rng.uniform(0.3, 1.7, 2) * np.exp(1j * rng.uniform(-3, 3, 2))
    d2 = rng.uniform(0.3, 1.7, 4) * np.exp(1j * rng.uniform(-3, 3, 4))
    op = R.PhaseProductOp((((1,), tuple(complex(v) for v in d1)),
                           ((0, n - 1), tuple(complex(v) for v in d2))))
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    np.testing.assert_allclose(_apply_port(n, [op_from_reference(op)], v),
                               R.make_op_matrix(n, op) @ v, atol=1e-10, rtol=0)


def test_non_unitary_diagonals_fuse_like_jax():
    """diag(1, 0.5) twice fuses and applies exactly; a projector diag(1, 0)
    never enters a phase product; the fused ops equal the JAX package's."""
    half = np.diag([1.0, 0.5]).astype(np.complex128).reshape(-1)
    proj = np.diag([1.0, 0.0]).astype(np.complex128).reshape(-1)
    for n, ref_ops in (
        (3, [R.make_matrix_op([0], half), R.make_matrix_op([1], half)]),
        (2, [R.make_matrix_op([0], proj), R.make_matrix_op([1], gates.T.reshape(-1))]),
    ):
        fused = fuse_ops(ops_from_reference(ref_ops))
        ref_fused = ref_fuse(ref_ops)
        assert [P.op_fingerprint(o) for o in fused] == [
            P.op_fingerprint(o) for o in ops_from_reference(ref_fused)]
        for f in fused:
            if isinstance(f, P.PhaseProductOp):
                assert all(v != 0 for _, d in f.terms for v in d)
        v = _state(n, 1)
        want = v
        for op in ref_ops:
            want = R.make_op_matrix(n, op) @ want
        np.testing.assert_allclose(_apply_port(n, fused, v), want, atol=1e-10, rtol=0)


def test_fingerprints_and_phase_product_dense():
    a, b_ = P.make_matrix_op([0], gates.X.reshape(-1)), P.make_matrix_op([0], gates.Y.reshape(-1))
    assert P.op_fingerprint(a) != P.op_fingerprint(b_)
    assert P.op_fingerprint(a) == P.op_fingerprint(P.make_matrix_op([0], gates.X.reshape(-1)))
    assert any(isinstance(part, bytes) for part in P.op_fingerprint(a))
    op = P.PhaseProductOp((((0,), (1 + 0j, 1j)), ((1,), (1 + 0j, -1j))))
    v = np.arange(1, 5).astype(np.complex128)
    np.testing.assert_allclose(_apply_port(2, [op], v), P.op_to_dense(op) @ v, atol=1e-12)


# -- tests/test_diagonal_fusion.py -------------------------------------------

def test_diagonal_detection_and_phase_product_match_jax():
    ops = [
        R.make_matrix_op([0], gates.T.reshape(-1)),
        R.make_matrix_op([3], gates.rz(0.31).reshape(-1)),
        R.make_control_op([1], R.make_matrix_op([5], gates.S.reshape(-1))),
        R.make_control_op([4, 2], R.make_matrix_op([0], gates.Z.reshape(-1))),
        R.make_matrix_op([0], gates.H.reshape(-1)),
        R.make_control_op([0], R.make_matrix_op([2], gates.X.reshape(-1))),
    ]
    terms = []
    for op in ops:
        got, want = P.diagonal_of(op_from_reference(op)), R.diagonal_of(op)
        assert (got is None) == (want is None)
        if want is not None:
            assert tuple(got[0]) == tuple(want[0])
            np.testing.assert_allclose(got[1], want[1], atol=1e-15)
            terms.append((tuple(want[0]), tuple(complex(v) for v in want[1])))
    pp = R.PhaseProductOp(tuple(terms))
    v = _state(6, 33)
    np.testing.assert_allclose(_apply_port(6, [op_from_reference(pp)], v),
                               _apply_ref(6, ops[:4], v), atol=1e-12, rtol=0)


def test_fusion_coalesces_diagonal_runs_like_jax():
    n = 8
    ops = [R.make_matrix_op([q], gates.T.reshape(-1)) for q in range(n)]
    ops += [R.make_control_op([q], R.make_matrix_op([q + 1], gates.Z.reshape(-1)))
            for q in range(n - 1)]
    fused = fuse_ops(ops_from_reference(ops), 4)
    assert len(fused) == 1 and isinstance(fused[0], P.PhaseProductOp)
    assert P.op_fingerprint(fused[0]) == P.op_fingerprint(
        op_from_reference(ref_fuse(ops, max_qubits=4)[0]))
    v = _state(n, 3)
    np.testing.assert_allclose(_apply_port(n, fused, v), _apply_ref(n, ops, v), atol=1e-12)
    b, rb = _port(), RefBuilder()
    algos.qfft(b, b.register(8))
    ref_algos.qfft(rb, rb.register(8))
    assert b.compile().num_passes == rb.compile().num_passes <= 26


# -- tests/test_swap_fastpaths.py --------------------------------------------

def test_swap_fast_paths_match_the_permutation():
    n = 12  # 5 row qubits (0..4), 7 lane qubits (5..11)
    cases = [[(0, 4), (1, 3)], [(1, 4), (2, 3)], [(0, 2), (1, 3)], [(0, 3)],
             [(5, 11), (7, 9)], [(2, 8)], [(0, 11), (1, 10), (2, 9), (3, 8), (4, 7), (5, 6)],
             [(0, 6), (1, 5), (2, 4)]]
    v = _state(n, 7)
    idx = np.arange(1 << n)
    for pairs in cases:
        src = idx.copy()
        for a, b in pairs:
            pa, pb = n - 1 - a, n - 1 - b
            ba, bb = (src >> pa) & 1, (src >> pb) & 1
            src = (src & ~((1 << pa) | (1 << pb))) | (bb << pa) | (ba << pb)
        op = P.make_swap_op([a for a, _ in pairs], [b for _, b in pairs])
        np.testing.assert_allclose(_apply_port(n, [op], v), v[src], atol=1e-12)
    pairs13 = [(a, 12 - a) for a in range(6)]
    v13 = _state(13, 8)
    op13 = R.make_swap_op([a for a, _ in pairs13], [b for _, b in pairs13])
    np.testing.assert_allclose(_apply_port(13, [op_from_reference(op13)], v13),
                               _apply_ref(13, [op13], v13), atol=1e-12)


def test_field_reversal_and_swap_schedule_match_jax():
    for n_m, pairs in ((5, [(1, 4), (2, 3)]), (5, [(0, 4), (1, 3)]), (5, [(0, 2), (1, 3)]),
                       (5, [(0, 3)]), (18, [(t, 17 - t) for t in range(9)])):
        assert port_apply._row_field_reversal(n_m, pairs) == \
            ref_apply._row_field_reversal(n_m, pairs)
    op = R.make_swap_op([0, 1, 2, 3, 4, 5], [11, 10, 9, 8, 7, 6])
    got = port_apply._swap_schedule(12, op_from_reference(op))
    want = ref_apply._swap_schedule(12, op)
    assert [sorted(x) for x in got] == [sorted(x) for x in want]
    assert sorted(got[0]) == [(0, 11), (1, 10), (2, 9), (3, 8), (4, 7)]


# -- tests/test_reflection.py -------------------------------------------------

def test_reflection_gates_inversion_and_diffusion():
    """The native reflection: its inversion rules, D then D^-1 is the
    identity, and against the gate-built diffusion (-D) under both
    conditioning modes, as in the JAX package."""
    (inv,) = invert_circuit_object(CircuitObject(3, ReflectionGate(3)))
    assert isinstance(inv.obj, ReflectionGate) and inv.obj.n == 3
    (cinv,) = invert_circuit_object(CircuitObject(4, ControlledMatGate(1, ReflectionGate(3))))
    assert isinstance(cinv.obj.mat, ReflectionGate)
    sub = _port()
    sub.apply_reflection(sub.register(4))
    sc = sub.make_subcircuit()
    b = _port()
    r = b.t(b.h(b.register(4)))
    b.apply_inverted_subcircuit(sc, b.apply_subcircuit(sc, r))
    b2 = _port()
    b2.t(b2.h(b2.register(4)))
    np.testing.assert_allclose(b.calculate_state_with_init([])[0],
                               b2.calculate_state_with_init([])[0], atol=1e-12)
    for native in (True, False):
        def state_of(build, native=native):
            bb = _port(native_conditioning=native)
            rr = bb.t(bb.h(bb.register(5)))
            rr = build(bb, rr)
            return bb.calculate_state_with_init([(rr, 3)])[0]

        np.testing.assert_allclose(state_of(lambda bb, rr: bb.apply_reflection(rr)),
                                   -state_of(lambda bb, rr: algos.grover.diffusion(bb, rr)),
                                   atol=1e-12)


@pytest.mark.parametrize("k,nctrl", [(3, 1), (3, 2), (1, 1), (2, 3)])
def test_conditioned_reflection_matches_jax(k, nctrl):
    def run(builder):
        c = builder.h(builder.register(nctrl))
        r = builder.t(builder.h(builder.register(k)))
        cb = builder.condition_with(c)
        cb.apply_reflection(r)
        cb.dissolve()
        return np.asarray(builder.calculate_state_with_init([])[0])

    for native in (True, False):
        np.testing.assert_allclose(run(_port(native_conditioning=native)),
                                   run(RefBuilder(dtype="f64", native_conditioning=native)),
                                   atol=1e-12)


def test_reflection_plans_standalone_and_shards():
    """The reflection stays its own sweep through fusion and planning; on a
    sharded state a global-touching one takes the grouped sum, a local
    one stays in the shard-local run, and both executors match the JAX
    package's single device (full, strict global subset, global + lane,
    controlled)."""
    n = 9
    ops = ops_from_reference([R.make_matrix_op([0], gates.H.reshape(-1)),
                              R.make_matrix_op([8], gates.H.reshape(-1)),
                              R.make_reflection_op(range(n)),
                              R.make_matrix_op([4], gates.T.reshape(-1))])
    fused = fuse_ops(ops)
    assert any(isinstance(op, P.ReflectionOp) for op in fused)
    for kernel_ok in (False, True):
        assert "op" in [k for k, _, _ in port_ra.plan_sweeps(n, fused, kernel_ok, TPU_REFERENCE)]
    n = 10

    def build(b, sub=None, ctrl=False):
        r = b.t(b.h(b.register(n)))
        if ctrl:
            res = b.split_register_relative(r, [0])
            cb = b.condition_with(res.selected)
            cb.apply_reflection(res.remaining)
            cb.dissolve()
        elif sub is None:
            b.apply_reflection(r)
        else:
            res = b.split_register_relative(r, sub)
            b.merge_two_registers(b.apply_reflection(res.selected), res.remaining)

    mesh = make_shard_mesh(8, devices=["cpu"] * 8)
    for kw in ({}, {"sub": [1, 4, 7]}, {"sub": [0, 1, 8, 9]}, {"ctrl": True}):
        rb = RefBuilder(dtype="f64")
        build(rb, **kw)
        want = np.asarray(rb.calculate_state(seed=0)[0])
        b = _port()
        build(b, **kw)
        entries = [e for item in b.pipeline for e in _lower_item(item)]
        for compiler in (compile_sharded, compile_sharded_explicit):
            state, _ = compiler(n, entries, np.complex128, mesh).run_complex(0)
            np.testing.assert_allclose(state, want, atol=1e-10)


def test_grover_native_diffusion_search_and_shards():
    n, marked = 8, 0b10110101
    rb = RefBuilder(dtype="f64")
    _, rh = ref_algos.grover.grover_search(rb, n, marked)
    p_gate = np.asarray(rb.calculate_state(seed=0)[1].get_stochastic_measurement(rh))
    b = _port()
    _, h = algos.grover.grover_search(b, n, marked, native_diffusion=True)
    p_native = b.calculate_state(seed=0)[1].get_stochastic_measurement(h)
    np.testing.assert_allclose(p_native, p_gate, atol=1e-10)
    assert int(np.argmax(p_native)) == marked and p_native[marked] > 0.99
    b3 = _port()
    _, h3 = algos.grover.grover_search(b3, n, marked, native_diffusion=True)
    re, im, m3 = sharded_calculate_state(b3, mesh=make_shard_mesh(8, devices=["cpu"] * 8),
                                         seed=0, strategy="explicit")
    np.testing.assert_allclose(m3.get_stochastic_measurement(h3), p_native, atol=1e-10)
    assert abs(np.linalg.norm(gather_state(re, im)) - 1) < 1e-10
