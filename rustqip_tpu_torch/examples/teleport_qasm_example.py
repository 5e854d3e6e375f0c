"""Port twin of ``examples/teleport_qasm_example.py``: quantum
teleportation from OpenQASM 2.0 text.

Exercises the QASM importer's full surface: a custom ``gate`` definition
prepares the payload, mid-circuit measurements feed classically-
conditioned corrections (``if (c==1) ...``, lowered exactly via the
deferred-measurement principle), and the teleported qubit is checked
against the payload. The outcomes per seed are drawn by a
``torch.Generator``, so they differ from the JAX package's; the fidelity
does not.

    python -m rustqip_tpu_torch.examples.teleport_qasm_example
"""

import numpy as np

from rustqip_tpu_torch.prelude import LocalBuilder
from rustqip_tpu_torch.qasm import circuit_from_qasm
from rustqip_tpu_torch.qasm.decompose import _u3_matrix

TELEPORT = """
OPENQASM 2.0;
include "qelib1.inc";
gate payload(theta, phi, lam) q { u3(theta, phi, lam) q; }
qreg q[3];
creg c0[1];
creg c1[1];
payload(0.7, 0.3, 1.1) q[0];
h q[1];
cx q[1], q[2];
cx q[0], q[1];
h q[0];
measure q[0] -> c0[0];
measure q[1] -> c1[0];
if (c1==1) x q[2];
if (c0==1) z q[2];
"""


def teleport(device="cuda", seed=None, outcomes=None):
    """One run of the teleport circuit: ``(m0, m1, fidelity)``. The two
    measurements are drawn from ``seed``, or forced to ``outcomes``
    (``(m0, m1)``)."""
    psi = _u3_matrix(0.7, 0.3, 1.1) @ np.array([1.0, 0.0])
    qc = circuit_from_qasm(TELEPORT, builder=LocalBuilder(device=device))
    h0, h1 = qc.measurements[0][1], qc.measurements[1][1]
    conditions = None if outcomes is None else dict(zip((h0, h1), outcomes))
    state, measured = qc.builder.calculate_state(seed=seed, conditions=conditions)
    state = np.asarray(state)
    m0 = measured.get_measurement(h0)[0]
    m1 = measured.get_measurement(h1)[0]
    base = 4 * m0 + 2 * m1  # qubit 0 -> bit 2, qubit 1 -> bit 1
    got = state[[base, base + 1]]
    return m0, m1, abs(np.vdot(psi, got)) ** 2


def main(device="cuda"):
    runs = []
    for seed in range(4):
        m0, m1, fidelity = teleport(device, seed=seed)
        print(
            f"seed={seed}: outcomes=({m0},{m1}) "
            f"teleported fidelity={fidelity:.10f}"
        )
        runs.append((m0, m1, fidelity))
    return {"runs": runs}


if __name__ == "__main__":
    main()
