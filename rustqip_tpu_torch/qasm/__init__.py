"""OpenQASM 2.0 export + import (port of ``rustqip_tpu/qasm/``).

Export re-designs ``qip/src/qasm.rs`` with export-time gate synthesis
(``decompose.py``); import (no reference analog) parses the qelib1 subset
back into a LocalBuilder so exported circuits round-trip.
"""

from rustqip_tpu_torch.qasm.export import to_openqasm, write_openqasm_file
from rustqip_tpu_torch.qasm.importer import QasmCircuit, circuit_from_qasm
from rustqip_tpu_torch.qasm.decompose import (
    synthesize_controlled,
    synthesize_unitary,
    zyz_angles,
)

__all__ = [
    "to_openqasm",
    "write_openqasm_file",
    "circuit_from_qasm",
    "QasmCircuit",
    "synthesize_unitary",
    "synthesize_controlled",
    "zyz_angles",
]
