"""Small sizes of the cells' configurations that a CPU test run holds: the
same circuits and traffic at 10-12 qubits, the port's kernel windows
planned and run through their plain versions."""

SMALL = {
    "qft32.amplitudes": {"num_qubits": 10},
    "qpe28.fresh": {"num_qubits": 12, "counting_qubits": 11, "phase_bits": 11},
    "qpe28.resident": {"num_qubits": 12, "counting_qubits": 11, "phase_bits": 11},
}
CPU = {"device": "cpu", "builder_kwargs": {"kernel_ok": True}}
#: Sizes at which the CPU plans kernel windows (1 for QFT-14, 3 for QPE-14).
FAULT = {
    "qft32.amplitudes": {"num_qubits": 14},
    "qpe28.fresh": {"num_qubits": 14, "counting_qubits": 13, "phase_bits": 13},
    "qpe28.resident": {"num_qubits": 14, "counting_qubits": 13, "phase_bits": 13},
}
