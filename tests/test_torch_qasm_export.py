"""QASM export in the port against the JAX package (twins of
``test_qasm.py`` and ``test_qasm_roundtrip.py``): the same circuit, built
the same way in both packages, exports to the same OpenQASM text, character
for character, and ``circuit_from_qasm`` of that text gives the same state in
both within 1e-10 in float64 (the port's run forced to the outcomes the JAX
run drew). QSD synthesis is held at 5 qubits, not the JAX file's 9.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from rustqip_tpu import qasm as JQ  # noqa: E402
from rustqip_tpu.builder import circuit_objects as JCO  # noqa: E402
from rustqip_tpu.prelude import LocalBuilder as JB  # noqa: E402

from rustqip_tpu_torch import qasm as PQ  # noqa: E402
from rustqip_tpu_torch.builder import circuit_objects as PCO  # noqa: E402
from rustqip_tpu_torch.errors import CircuitError  # noqa: E402
from rustqip_tpu_torch.prelude import LocalBuilder as PB  # noqa: E402

torch.set_num_threads(1)  # the test runner keeps one worker per core busy

F64 = np.complex128
TOL = 1e-10


def _builders():
    return JB(dtype=F64), PB(dtype=F64, device="cpu")


def import_states_match(text):
    """``circuit_from_qasm`` of ``text`` in both packages: equal widths,
    equal states (the port forced to the JAX run's outcomes) and equal
    measurement probabilities, within ``TOL``."""
    jq = JQ.circuit_from_qasm(text, builder=JB(dtype=F64))
    pq = PQ.circuit_from_qasm(text, builder=PB(dtype=F64, device="cpu"))
    assert jq.n == pq.n and len(jq.measurements) == len(pq.measurements)
    js, jm = jq.builder.calculate_state(seed=0)
    pairs = list(zip(jq.measurements, pq.measurements))
    conditions = {ph: jm.get_measurement(jh)[0] for (_, jh), (_, ph) in pairs}
    ps, pm = pq.builder.calculate_state(seed=0, conditions=conditions or None)
    np.testing.assert_allclose(ps, js, atol=TOL, rtol=0)
    for (_, jh), (_, ph) in pairs:
        assert abs(pm.get_measurement(ph)[1] - jm.get_measurement(jh)[1]) <= TOL
    return js


def _unitary(seed, dim):
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim)))
    return u


def header_and_registers(b, co):
    q = b.qubit()
    b.register(2)
    q = b.h(q)
    b.measure(q)


def cx(b, co):
    b.cnot(b.qubit(), b.qubit())


def named_swap(b, co):
    merged = b.merge_two_registers(b.register(2), b.register(2))
    b.apply_circuit_object(merged, co.CircuitObject(4, co.NamedGate("SWAP")))


def rz_symbolic(b, co):
    b.rz_pi_by(b.qubit(), 4)


def rz_float(b, co):
    b.rz(b.qubit(), 0.5)


def global_phase_and_mat(b, co):
    q = b.apply_global_phase_pi_by(b.qubit(), 2)
    b.apply_vec_matrix(q, np.eye(2).reshape(-1))


def stochastic(b, co):
    b.measure_stochastic(b.qubit())


def creg_sizing(b, co):
    ra, rb = b.register(2), b.register(2)
    b.measure(b.x(ra))
    b.measure(rb)


def conditioned_mat(b, co):
    c, t = b.qubit(), b.qubit()
    c = b.h(c)
    cb = b.condition_with(c)
    cb.apply_matrix(t, _unitary(0, 2))
    cb.dissolve()


def conditioned_swap(b, co):
    c, ra, rb = b.qubit(), b.register(2), b.register(2)
    c = b.h(c)
    ra = b.x(ra)
    cb = b.condition_with(c)
    cb.swap(ra, rb)
    cb.dissolve()


def conditioned_named_swap(b, co):
    c, r = b.qubit(), b.register(2)
    c = b.h(c)
    r = b.x(r)
    b.try_apply_with_condition(c, r, co.CircuitObject(2, co.NamedGate("SWAP")))


def multi_controlled_x(b, co):
    cr, t = b.register(2), b.qubit()
    cr = b.h(cr)
    cb = b.condition_with(cr)
    cb.x(t)
    cb.dissolve()


def triple_controlled_unitary(b, co):
    cr, t = b.register(3), b.qubit()
    cr = b.h(cr)
    cb = b.condition_with(cr)
    cb.apply_matrix(t, _unitary(1, 2))
    cb.dissolve()


def multiqubit_mat(b, co):
    r = b.h(b.register(3))
    b.apply_matrix(r, _unitary(2, 8))


def sparse_mat(b, co):
    r = b.h(b.register(3))
    perm = [3, 0, 7, 1, 5, 2, 6, 4]
    b.apply_sparse_matrix(r, [[(perm[i], 1.0)] for i in range(8)])


def named_gates(b, co):
    q0, q1, q2 = b.qubit(), b.qubit(), b.qubit()
    q0 = b.h(q0)
    q0, q1 = b.cnot(q0, q1)
    q1 = b.t(q1)
    q2 = b.s(q2)
    q1, q2 = b.swap(q1, q2)
    q2 = b.y(q2)
    b.rz(q0, 0.7)


def measurement(b, co):
    q, t = b.qubit(), b.qubit()
    q = b.h(q)
    q, t = b.cnot(q, t)
    b.measure(q)


def fn_gate(b, co):
    """A 3-qubit function oracle (an affine permutation): the export
    materializes it and synthesizes the matrix."""
    r = b.h(b.register(3))
    b.apply_fn_matrix(r, lambda row: ((row * 5 + 3) % 8, 1.0), tag="affine-3")


CASES = [header_and_registers, cx, named_swap, rz_symbolic, rz_float,
         global_phase_and_mat, stochastic, creg_sizing, conditioned_mat,
         conditioned_swap, conditioned_named_swap, multi_controlled_x,
         triple_controlled_unitary, multiqubit_mat, sparse_mat, named_gates,
         measurement, fn_gate]


@pytest.mark.parametrize("build", CASES, ids=[c.__name__ for c in CASES])
def test_export_text_and_import_state_match_jax(build):
    jb, pb = _builders()
    build(jb, JCO)
    build(pb, PCO)
    text = pb.to_openqasm()
    assert text == jb.to_openqasm()
    assert "exceeds synthesis cap" not in text
    import_states_match(text)


def test_write_openqasm_file_matches_jax(tmp_path):
    jb, pb = _builders()
    for b in (jb, pb):
        q = b.h(b.qubit())
        b.measure(q)
    pb.write_openqasm_file(tmp_path / "port.qasm")
    jb.write_openqasm_file(tmp_path / "jax.qasm")
    text = (tmp_path / "port.qasm").read_text()
    assert text == pb.to_openqasm() == (tmp_path / "jax.qasm").read_text()


def test_wide_oracle_export_comments_like_jax():
    """An 11-qubit sparse op is past the synthesis cap: both packages say so
    in the same comment instead of dropping the op."""
    jb, pb = _builders()
    rows = [[(i, 1.0)] for i in range(1 << 11)]
    for b in (jb, pb):
        b.apply_sparse_matrix(b.register(11), rows)
    text = PQ.to_openqasm(pb)
    assert "exceeds synthesis cap" in text and text == JQ.to_openqasm(jb)


def test_importer_rejects_unknown():
    with pytest.raises(CircuitError):
        PQ.circuit_from_qasm("qreg q[1]; frobnicate q[0];",
                             builder=PB(dtype=F64, device="cpu"))


def test_importer_parses_pi_expressions():
    text = ('OPENQASM 2.0;\ninclude "qelib1.inc";\nqreg q[1];\n'
            "u1(3*pi/4) q[0];\nrx(-pi/2) q[0];\n")
    state = import_states_match(text)
    assert abs(np.linalg.norm(state) - 1) < 1e-10


def test_qsd_cap_env_override_and_five_qubit_synthesis(monkeypatch):
    """``RUSTQIP_TPU_QSD_CAP`` moves the port's cap as the JAX package's;
    a 5-qubit QSD stream equals the JAX package's gate for gate and
    multiplies out to the unitary."""
    from rustqip_tpu.qasm import decompose as JD

    from rustqip_tpu_torch.qasm import decompose as PD

    assert PD.qsd_cap() == JD.qsd_cap() == 10
    for value, cap in (("4", 4), ("8q", 10), ("0", 10)):
        monkeypatch.setenv("RUSTQIP_TPU_QSD_CAP", value)
        assert PD.qsd_cap() == JD.qsd_cap() == cap
    u = _unitary(3, 32)
    monkeypatch.setenv("RUSTQIP_TPU_QSD_CAP", "4")
    with pytest.raises(CircuitError, match="cap 4"):
        PD.synthesize_unitary(u, list(range(5)))
    monkeypatch.setenv("RUSTQIP_TPU_QSD_CAP", "5")
    gates = PD.synthesize_unitary(u, list(range(5)))
    assert gates == JD.synthesize_unitary(u, list(range(5)))
    np.testing.assert_allclose(PD.gates_to_matrix(gates, list(range(5))), u, atol=1e-9)
