"""QASM import in the port against the JAX package (twins of the state
cases of ``test_qasm_import_ext.py``): custom gate definitions, ``if``
statements lowered by deferred measurement, ``reset`` and whole-register
measurement. Each text is imported by both packages and run in float64;
the JAX run draws its outcomes from a seed, the port's run is forced to
those outcomes, and the states and measurement probabilities must agree
within 1e-10.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from rustqip_tpu import qasm as JQ  # noqa: E402
from rustqip_tpu.prelude import LocalBuilder as JB  # noqa: E402

from rustqip_tpu_torch import qasm as PQ  # noqa: E402
from rustqip_tpu_torch.prelude import LocalBuilder as PB  # noqa: E402

torch.set_num_threads(1)  # the test runner keeps one worker per core busy

F64 = np.complex128
TOL = 1e-10
HEADER = 'OPENQASM 2.0;\ninclude "qelib1.inc";\n'

TELEPORT = HEADER + (
    "qreg q[3];\ncreg c0[1];\ncreg c1[1];\n"
    "u3(0.7,0.3,1.1) q[0];\nh q[1];\ncx q[1],q[2];\ncx q[0],q[1];\nh q[0];\n"
    "measure q[0] -> c0[0];\nmeasure q[1] -> c1[0];\n"
    "if (c1==1) x q[2];\nif (c0==1) z q[2];\n"
)
RESET = HEADER + "qreg q[1];\ncreg c[1];\nh q[0];\nreset q[0];\nmeasure q[0] -> c[0];\n"

CASES = {
    "custom_gate_definition": HEADER + (
        "gate bellish(theta) a, b { h a; cx a,b; rz(theta) b; }\n"
        "qreg q[2];\nbellish(pi/3) q[0], q[1];\n"),
    "custom_gate_nested_param_arithmetic": HEADER + (
        "gate phz(t) a { rz(2*t) a; }\n"
        "gate pair(t) a, b { h a; cx a,b; phz(t/2) b; }\n"
        "qreg q[2];\npair(pi/4) q[0], q[1];\n"),
    **{f"teleportation_via_if_seed{s}": (TELEPORT, s) for s in range(6)},
    "if_multibit_condition": HEADER + (
        "qreg q[3];\ncreg c[2];\nx q[0];\nx q[1];\n"
        "measure q[0] -> c[0];\nmeasure q[1] -> c[1];\n"
        "if (c==3) x q[2];\nif (c==1) x q[2];\n"),
    "if_on_custom_gate": HEADER + (
        "gate flip a { x a; }\nqreg q[2];\ncreg c[1];\n"
        "x q[0];\nmeasure q[0] -> c[0];\nif (c==1) flip q[1];\n"),
    "two_ifs_share_control_freshness": HEADER + (
        "qreg q[3];\ncreg c[1];\nx q[0];\nmeasure q[0] -> c[0];\n"
        "if (c==1) x q[1];\nif (c==1) x q[2];\n"),
    **{f"reset_yields_zero_seed{s}": (RESET, s) for s in range(4)},
    "reset_entangled_marginal": HEADER + (
        "qreg q[2];\ncreg c[2];\nh q[0];\ncx q[0],q[1];\nreset q[0];\n"
        "measure q[0] -> c[0];\n"),
    "reset_then_reuse": HEADER + (
        "qreg q[1];\ncreg c[1];\nx q[0];\nreset q[0];\nx q[0];\nmeasure q[0] -> c[0];\n"),
    "measure_whole_register_maps_creg_bits": HEADER + (
        "qreg a[2];\nqreg b[1];\ncreg c[2];\nx a[1];\nmeasure a -> c;\nif (c==2) x b[0];\n"),
    "scientific_notation_params": HEADER + (
        "qreg q[1];\nh q[0];\nrz(6.123233995736766e-17) q[0];\nrx(2.5e-1) q[0];\n"),
    "if_duplicate_source_qubit_dedups": HEADER + (
        "qreg q[2];\ncreg c[2];\nx q[0];\n"
        "measure q[0] -> c[0];\nmeasure q[0] -> c[1];\nif (c==3) x q[1];\n"),
    "swap_and_cswap": HEADER + (
        "qreg q[3];\nx q[0];\nh q[1];\nswap q[0],q[2];\ncswap q[1],q[0],q[2];\n"
        "gate sw a, b { swap a,b; }\nsw q[1],q[0];\n"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_import_state_matches_jax(name):
    text, seed = CASES[name] if isinstance(CASES[name], tuple) else (CASES[name], 0)
    jq = JQ.circuit_from_qasm(text, builder=JB(dtype=F64))
    pq = PQ.circuit_from_qasm(text, builder=PB(dtype=F64, device="cpu"))
    assert jq.n == pq.n and jq.creg_map == pq.creg_map
    assert [q for q, _ in jq.measurements] == [q for q, _ in pq.measurements]
    js, jm = jq.builder.calculate_state(seed=seed)
    pairs = list(zip(jq.measurements, pq.measurements))
    conditions = {ph: jm.get_measurement(jh)[0] for (_, jh), (_, ph) in pairs}
    ps, pm = pq.builder.calculate_state(seed=seed, conditions=conditions or None)
    np.testing.assert_allclose(ps, js, atol=TOL, rtol=0)
    for (_, jh), (_, ph) in pairs:
        assert abs(pm.get_measurement(ph)[1] - jm.get_measurement(jh)[1]) <= TOL
    assert abs(np.linalg.norm(ps) - 1) <= 1e-12


def test_qft_text_of_all_ones_sees_every_statement():
    """The closed-form check that ``chip_smoke.py`` and the GPU tests put on
    an imported QFT can fail. From the basis state with every input bit set
    each controlled phase acts (the QFT applies it while its control is
    still a basis qubit), so dropping any one ``cu3`` or ``swap`` statement
    of the exported QFT-8 moves the imported state off
    exp(2 pi i x k / 2^n) / 2^(n/2) by more than 1e-6."""
    from rustqip_tpu_torch.algos import qfft

    n = 8
    b = PB(dtype=F64, device="cpu")
    qfft(b, b.x(b.register(n)))
    lines = b.to_openqasm().splitlines()
    k = np.arange(1 << n)
    want = np.exp(2j * np.pi * (((1 << n) - 1) * k % (1 << n)) / (1 << n)) / 2 ** (n / 2)

    def err(text):
        imp = PQ.circuit_from_qasm(text, builder=PB(dtype=F64, device="cpu"))
        return np.abs(imp.builder.calculate_state(seed=0)[0] - want).max()

    assert err("\n".join(lines) + "\n") <= TOL
    acting = [i for i, ln in enumerate(lines)
              if ln.startswith("swap ") or (ln.startswith("cu3(") and not ln.startswith("cu3(0,0,0)"))]
    assert len(acting) == n * (n - 1) // 2 + n // 2
    for i in acting:
        assert err("\n".join(lines[:i] + lines[i + 1:]) + "\n") > 1e-6, lines[i]


def _reflection_roundtrip(build):
    """Export a reflection circuit from both packages (the same text) and
    import it into the port; returns (original state, imported state with
    export-time ancillas dropped, JAX package's imported state likewise)."""
    jb, pb = JB(dtype=F64), PB(dtype=F64, device="cpu")
    build(jb)
    build(pb)
    text = PQ.to_openqasm(pb)
    assert text == JQ.to_openqasm(jb)
    assert "exceeds synthesis cap" not in text
    s1 = np.asarray(pb.calculate_state_with_init([])[0])
    np.testing.assert_allclose(s1, np.asarray(jb.calculate_state_with_init([])[0]), atol=TOL)
    out = []
    for imp in (PQ.circuit_from_qasm(text, builder=PB(dtype=F64, device="cpu")),
                JQ.circuit_from_qasm(text, builder=JB(dtype=F64))):
        s2 = np.asarray(imp.builder.calculate_state_with_init([])[0])
        if s2.size > s1.size:  # export-time ancillas end in |0>
            s2 = s2.reshape(s1.size, -1)
            np.testing.assert_allclose(np.abs(s2[:, 1:]), 0.0, atol=1e-9)
            s2 = s2[:, 0]
        out.append(s2)
    np.testing.assert_allclose(out[0], out[1], atol=TOL)
    return s1, out[0]


def test_reflection_qasm_export_roundtrip():
    """Gate expansion drops the reflection's -1 global phase (the QASM 2.0
    policy): the imported state equals the original up to one phase."""
    def build(b):
        r = b.register(3)
        r = b.h(r)
        r = b.t(r)
        b.apply_reflection(r)

    s1, s2 = _reflection_roundtrip(build)
    j = int(np.argmax(np.abs(s1)))
    phase = s1[j] / s2[j]
    np.testing.assert_allclose(abs(phase), 1.0, atol=1e-9)
    np.testing.assert_allclose(s2 * phase, s1, atol=1e-9)


def test_controlled_reflection_qasm_export_exact():
    """A controlled reflection's relative phase is observable, and the
    dense synthesis keeps it: equal up to one phase for the circuit."""
    def build(b):
        c, r = b.qubit(), b.register(2)
        c = b.h(c)
        r = b.h(r)
        r = b.t(r)
        cb = b.condition_with(c)
        cb.apply_reflection(r)
        cb.dissolve()

    s1, s2 = _reflection_roundtrip(build)
    j = int(np.argmax(np.abs(s1)))
    np.testing.assert_allclose(s2 * (s1[j] / s2[j]), s1, atol=1e-9)
