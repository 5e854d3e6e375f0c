"""A quantum volume model circuit (``reference.qv.circuit``): every
Haar-random SU(4) applied to its pair through ``apply_matrix`` on the
pair merged into one register, qubit a the more significant bit."""

from portbench.reference.qv import circuit


def build(b, cfg: dict, params: dict) -> None:
    qs = [b.qubit() for _ in range(int(cfg["num_qubits"]))]
    for layer in circuit(cfg, params):
        for a, c, u in layer:
            qs[a], qs[c] = b.split_all_register(b.apply_matrix(b.merge_registers([qs[a], qs[c]]), u))
