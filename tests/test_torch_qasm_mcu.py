"""The port's QASM importer refusals, multi-controlled synthesis (the
clean-ancilla Toffoli ladder) and arithmetic export against the JAX
package (twins of the refusals of ``test_qasm_import_ext.py``, of
``test_qasm_mcu.py`` and of ``test_qasm_arithmetic.py``): the same
``CircuitError`` for the same bad text, the same gate streams, the same
exported text, and the same imported states within 1e-10 in float64.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from rustqip_tpu import qasm as JQ  # noqa: E402
from rustqip_tpu.errors import CircuitError as JError  # noqa: E402
from rustqip_tpu.prelude import LocalBuilder as JB  # noqa: E402
from rustqip_tpu.qasm import decompose as JD  # noqa: E402

from rustqip_tpu_torch import qasm as PQ  # noqa: E402
from rustqip_tpu_torch.errors import CircuitError  # noqa: E402
from rustqip_tpu_torch.prelude import LocalBuilder as PB  # noqa: E402
from rustqip_tpu_torch.qasm import decompose as PD  # noqa: E402

torch.set_num_threads(1)  # the test runner keeps one worker per core busy

F64 = np.complex128
TOL = 1e-10
HEADER = 'OPENQASM 2.0;\ninclude "qelib1.inc";\n'

REFUSED = {
    "custom_gate_wrong_arity": ("expects 2 qubits", "gate gg a, b { cx a,b; }\nqreg q[3];\ngg q[0], q[1], q[2];\n"),
    "custom_gate_unknown_param_name": ("Unknown name", "gate gg(t) a { rz(t + bogus) a; }\nqreg q[1];\ngg(1.0) q[0];\n"),
    "if_unmeasured_creg": ("unmeasured", "qreg q[2];\ncreg c[1];\nif (c==1) x q[1];\n"),
    "if_after_source_modified": ("modified after", "qreg q[2];\ncreg c[1];\nmeasure q[0] -> c[0];\nh q[0];\nif (c==1) x q[1];\n"),
    "if_value_out_of_range": ("out of range", "qreg q[2];\ncreg c[1];\nmeasure q[0] -> c[0];\nif (c==2) x q[1];\n"),
    "measure_out_of_range_creg_bit": ("out of range", "qreg q[2];\ncreg c0[1];\ncreg c1[1];\nmeasure q[0] -> c0[1];\n"),
    "if_targeting_own_source": ("own source", "qreg q[1];\ncreg c[1];\nmeasure q[0] -> c[0];\nif (c==1) x q[0];\n"),
    "recursive_gate_definition": ("Recursive gate definition", "gate g a { h a; g a; }\nqreg q[1];\ng q[0];\n"),
    "mutually_recursive_gate_definitions": ("Recursive gate definition", "gate g1 a { g2 a; }\ngate g2 a { g1 a; }\nqreg q[1];\ng1 q[0];\n"),
    "if_duplicate_source_conflicting_bits": ("unsatisfiable", "qreg q[2];\ncreg c[2];\nmeasure q[0] -> c[0];\nmeasure q[0] -> c[1];\nif (c==1) x q[1];\n"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_import_refuses_like_jax(name):
    match, body = REFUSED[name]
    with pytest.raises(JError, match=match):
        JQ.circuit_from_qasm(HEADER + body, builder=JB(dtype=F64))
    with pytest.raises(CircuitError, match=match):
        PQ.circuit_from_qasm(HEADER + body, builder=PB(dtype=F64, device="cpu"))


def _unitary(k, seed):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(1 << k, 1 << k)) + 1j * rng.normal(size=(1 << k, 1 << k))
    return np.linalg.qr(m)[0]


@pytest.mark.parametrize("nc,nt", [(2, 1), (3, 1), (5, 1), (3, 2)])
def test_mcu_ladder_stream_matches_jax(nc, nt):
    """The port's ladder equals the JAX package's gate for gate; up to 7
    qubits its product is the controlled unitary on the ancilla-|0>
    subspace, with the ancillas returned to |0>."""
    U = _unitary(nt, seed=nc * 10 + nt)
    ctrls, tgts = list(range(nc)), list(range(nc, nc + nt))
    anc = list(range(nc + nt, nc + nt + nc - 1))
    gates = PD.synthesize_mcu(U, ctrls, tgts, anc)
    assert gates == JD.synthesize_mcu(U, ctrls, tgts, anc)
    if nc + nt + len(anc) > 7:
        return
    M = PD.gates_to_matrix(gates, ctrls + tgts + anc)
    step = 1 << len(anc)
    want = np.eye(1 << (nc + nt), dtype=np.complex128)
    want[-(1 << nt):, -(1 << nt):] = U
    np.testing.assert_allclose(M[::step, ::step], want, atol=1e-9)
    for r_off in range(1, step):
        np.testing.assert_allclose(M[r_off::step, ::step], 0.0, atol=1e-9)


def test_mcu_requires_enough_ancillas():
    with pytest.raises(CircuitError, match="ancillas"):
        PD.synthesize_mcu(_unitary(1, 0), [0, 1, 2], [3], [4])


def _controlled(nc, nt, seed, prep):
    def build(b):
        c, t = b.register(nc), b.register(nt)
        c = prep(b, c)
        cb = b.condition_with(c)
        cb.apply_matrix(t, _unitary(nt, seed))
        cb.dissolve()
        return []

    return build


def _arith(name):
    def build(b):
        from rustqip_tpu_torch.algos import arithmetic as PA
        from rustqip_tpu.algos import arithmetic as JA

        A = PA if isinstance(b, PB) else JA
        if name == "add":
            regs = A.add(b, b.register(2), b.register(2), b.register(3))
            return list(zip(regs, (0, 2, 1)))
        regs = A.add_mod(b, b.register(2), b.register(3), b.register(2))
        return list(zip(regs, (2, 1, 3)))

    return build


EXPORTS = {
    "five_controls_ladder": (_controlled(5, 1, 7, lambda b, c: b.h(c)), "qreg anc[4];"),
    "nine_controls_beyond_old_cap": (_controlled(9, 1, 11, lambda b, c: b.x(c)), "qreg anc[8];"),
    "two_qubit_target_seven_controls": (_controlled(7, 2, 3, lambda b, c: b.h(c)), "qreg anc[6];"),
    "small_controlled_no_ancilla": (_controlled(2, 1, 5, lambda b, c: b.h(c)), None),
    "add": (_arith("add"), None),
    "add_mod": (_arith("add_mod"), None),
}


@pytest.mark.parametrize("name", sorted(EXPORTS))
def test_export_and_import_match_jax(name):
    """Export text equal to the JAX package's; the imported circuit, run
    from the same basis input (register values set qubit by qubit), gives
    the JAX package's state within 1e-10, ancillas included."""
    build, anc_line = EXPORTS[name]
    jb, pb = JB(dtype=F64), PB(dtype=F64, device="cpu")
    jinit, pinit = build(jb), build(pb)
    text = PQ.to_openqasm(pb)
    assert text == JQ.to_openqasm(jb)
    assert "exceeds synthesis cap" not in text
    if anc_line:
        assert anc_line in text
    elif name.startswith("small"):
        assert "anc" not in text
    states = []
    for Q, init, B in ((JQ, jinit, JB(dtype=F64)), (PQ, pinit, PB(dtype=F64, device="cpu"))):
        imp = Q.circuit_from_qasm(text, builder=B)
        per_qubit = [(imp.qubits[reg.indices[j]], (val >> j) & 1)
                     for reg, val in init for j in range(reg.n)]
        states.append(imp.builder.calculate_state_with_init(per_qubit, seed=0)[0])
    np.testing.assert_allclose(states[1], states[0], atol=TOL, rtol=0)
    if name == "add":  # a = 2, b = 1: rb reads 3 on the winning basis state
        (_, _), (_, _), (rb, _) = pinit
        idx = int(np.argmax(np.abs(states[1])))
        n = pb.n
        assert sum(((idx >> (n - 1 - q)) & 1) << j for j, q in enumerate(rb.indices)) == 3
