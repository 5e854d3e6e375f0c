"""The port end to end, through ``LocalBuilder``: the pinned golden vectors
of ``tests/test_golden_reference.py``, QFT and Grover against the JAX
package's builder in f64 (1e-10) and f32 (1e-5 end to end), with the
kernel path on (kernel windows through the kernel's plain version on the
CPU) and off, and forced / stochastic measurements against the
reference's."""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")

from rustqip_tpu_torch.algos import grover_iteration, grover_search, qfft  # noqa: E402
from rustqip_tpu_torch.dsl.program import negate_bitmask  # noqa: E402
from rustqip_tpu_torch.errors import CircuitError  # noqa: E402
from rustqip_tpu_torch.prelude import (  # noqa: E402
    LocalBuilder,
    MeasuredCondition,
    PiRational,
)

R2 = 1.0 / np.sqrt(2.0)
TOL = {"f64": 1e-10, "f32": 1e-5}


def test_golden_bell_pair():
    b = LocalBuilder(dtype="f64", device="cpu")
    ra = b.h(b.qubit())
    rb = b.qubit()
    cb = b.condition_with(ra)
    rb = cb.not_(rb)
    ra = cb.dissolve()
    r, handle = b.measure_stochastic(b.merge_two_registers(ra, rb))
    state, meas = b.calculate_state(seed=0)
    golden = np.array([R2, 0, 0, R2], dtype=np.complex128)
    np.testing.assert_allclose(state, golden, atol=1e-10)
    np.testing.assert_allclose(
        meas.get_stochastic_measurement(handle), np.abs(golden) ** 2, atol=1e-10
    )


def test_golden_identity_mask_negation():
    """macro_example.rs: the control(0b110) line's X pair leaves e_0."""
    b = LocalBuilder(dtype="f64", device="cpu")
    ra = b.qudit(3)
    rb = b.qudit(3)
    rb = negate_bitmask(b, rb, 0b110)
    rb = negate_bitmask(b, rb, 0b110)
    assert len(b.pipeline) == 2
    state, _ = b.calculate_state(seed=0)
    golden = np.zeros(64, dtype=np.complex128)
    golden[0] = 1.0
    np.testing.assert_allclose(state, golden, atol=1e-10)


def test_golden_inverse_roundtrip():
    """inverse_example.rs: gamma = toffoli(ra, rb); toffoli(rb, ra), then
    its inverted replay: the identity, through real decompositions."""
    b = LocalBuilder(dtype="f64", device="cpu")
    ra = b.register(3)
    rb = b.register(3)
    x, y = b.split_first_qubit(ra)[::-1]
    x = b.merge_two_registers(x, y)
    c, t = b.split_last_qubit(x)
    c, t = b.toffoli(c, t)
    t, c = b.toffoli(t, c)
    sc = b.make_subcircuit()
    assert len(sc) > 8
    r = b.merge_registers([*b.split_all_register(b.merge_two_registers(c, t)),
                           *b.split_all_register(rb)])
    b.apply_inverted_subcircuit(sc, r)
    state, _ = b.calculate_state(seed=0)
    golden = np.zeros(64, dtype=np.complex128)
    golden[0] = 1.0
    np.testing.assert_allclose(state, golden, atol=1e-10)


@pytest.mark.parametrize("outcome", [0, 1])
@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_golden_cswap(outcome, prec):
    b = LocalBuilder(dtype=prec, device="cpu")
    q = b.qubit()
    ra = b.register(3)
    rb = b.register(3)
    q = b.h(q)
    cb = b.condition_with(q)
    ra, rb = cb.swap(ra, rb)
    q = cb.dissolve()
    q = b.h(q)
    q, m = b.measure(q)
    state, measured = b.calculate_state_with_init(
        [(ra, 0b000), (rb, 0b001)], seed=0, conditions={m: outcome}
    )
    result, p = measured.get_measurement(m)
    assert result == outcome and abs(p - 0.5) < TOL[prec]
    golden = np.zeros(128, dtype=np.complex128)
    if outcome == 0:
        golden[4] = golden[32] = R2
    else:
        golden[68], golden[96] = R2, -R2
    np.testing.assert_allclose(state, golden, atol=TOL[prec])


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


def test_qft_is_the_dft():
    n = 6
    b = LocalBuilder(dtype="f64", device="cpu")
    r = b.register(n)
    qfft(b, r)
    from rustqip_tpu_torch.builder.traits import make_circuit_matrix

    mat = make_circuit_matrix(b, r)
    N = 1 << n
    jk = np.outer(np.arange(N), np.arange(N))
    np.testing.assert_allclose(mat, np.exp(2j * np.pi * jk / N) / np.sqrt(N), atol=1e-10)


def _measured_circuit(b, side):
    """Mid-circuit collapsing measurements, a forced outcome with a prob
    override, a stochastic read-out and a repeat block."""
    if side == "ref":
        from rustqip_tpu.types import PiRational as Pi
    else:
        Pi = PiRational
    q = b.register(3)
    q = b.h(q)
    a, rest = b.split_first_qubit(q)[::-1]
    a = b.rz(a, Pi(1, 3))
    a, m1 = b.measure(a)
    cb = b.condition_with(a)
    rest = cb.h(rest)
    a = cb.dissolve()
    rest = b.repeat(2, lambda bb, rr: bb.t(bb.h(rr)), rest)
    rest, m2 = b.measure(rest)
    r = b.merge_two_registers(a, rest)
    r, m3 = b.measure_stochastic(r)
    return m1, m2, m3


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_forced_measurements_match_reference(prec):
    from rustqip_tpu.ops.measurement_ops import MeasuredCondition as RMC
    from rustqip_tpu.prelude import LocalBuilder as RB

    rb = RB(dtype=prec)
    r1, r2, r3 = _measured_circuit(rb, "ref")
    rstate, rmeas = rb.calculate_state(
        seed=0, conditions={r1: 1, r2: RMC(2, 0.3)}
    )
    pb = LocalBuilder(dtype=prec, device="cpu")
    p1, p2, p3 = _measured_circuit(pb, "port")
    pstate, pmeas = pb.calculate_state(
        seed=0, conditions={p1: 1, p2: MeasuredCondition(2, 0.3)}
    )
    for rh, ph in ((r1, p1), (r2, p2)):
        ro, rp = rmeas.get_measurement(rh)
        po, pp = pmeas.get_measurement(ph)
        assert po == ro and abs(pp - rp) <= TOL[prec]
    np.testing.assert_allclose(
        pmeas.get_stochastic_measurement(p3),
        rmeas.get_stochastic_measurement(r3), atol=TOL[prec],
    )
    assert np.abs(pstate - np.asarray(rstate)).max() <= TOL[prec]


def test_grover_search_finds_marked():
    n, marked = 6, 0b101101
    b = LocalBuilder(dtype="f64", device="cpu")
    _, handle = grover_search(b, n, marked)
    _, meas = b.calculate_state(seed=1)
    probs = meas.get_stochastic_measurement(handle)
    assert int(np.argmax(probs)) == marked and probs[marked] > 0.9
    counts = meas.sample_counts(handle, 100, seed=3)
    assert max(counts, key=counts.get) == marked


def test_sampling_is_reproducible_from_seed():
    def run(seed):
        b = LocalBuilder(dtype="f32", device="cpu")
        q = b.h(b.register(4))
        q, m = b.measure(q)
        _, meas = b.calculate_state(seed=seed)
        return meas.get_measurement(m)

    assert run(5) == run(5)
    outcome, p = run(5)
    assert abs(p - 1 / 16) < 1e-6


def test_unported_surfaces_raise():
    """QASM export (ROADMAP port queue P4) is the builder surface still
    unported: it raises and names the queue."""
    b = LocalBuilder(device="cpu")
    b.h(b.register(2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        b.to_openqasm()
    with pytest.raises(CircuitError):
        b.calculate_state(conditions={0: 1})


def test_entry_points_default_to_the_card():
    """LocalBuilder, CompiledCircuit and compile_pipeline target CUDA unless
    the caller passes device="cpu" (nothing is allocated here)."""
    import inspect

    from rustqip_tpu_torch.engine.compile import CompiledCircuit, compile_pipeline

    assert LocalBuilder().device.type == "cuda"
    for fn in (CompiledCircuit.__init__, compile_pipeline):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
