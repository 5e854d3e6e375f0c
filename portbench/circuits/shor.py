"""Shor's order finding through the port's own algorithm
(``rustqip_tpu_torch.algos.shor.shor_period_circuit``): t counting qubits
in H, counting qubit j controlling U^(2^j), U|y> = |a y mod N>, on a work
register of L qubits set to |1>, the inverse QFT of the counting register,
and its outcome distribution."""

from rustqip_tpu_torch.algos.shor import shor_period_circuit


def build(b, cfg: dict, params: dict) -> None:
    shor_period_circuit(b, int(params["base"]), int(cfg["modulus"]),
                        t=int(cfg["counting_qubits"]))
