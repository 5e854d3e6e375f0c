"""QFT on every qubit of the state, final reversal included
(``rustqip_tpu_torch.algos.qfft``)."""

from rustqip_tpu_torch.algos import qfft


def build(b, cfg: dict, params: dict) -> None:
    qfft(b, b.register(int(cfg["num_qubits"])))
