"""Share of its bound at which the monomial pass runs, in %: a job's least
bytes of the pass at the HBM rate over ``monomial_ms``'s device time a
job. The bytes come from the configuration alone (Shor's order finding):
each of the t controlled multiplications must read and write once both
float32 planes of the 2^(n-1) amplitudes its control selects, so the
share cannot pass 100 % while every launch is one such pass."""

from portbench import roofline
from portbench.metrics import monomial_ms


def least_bytes(cfg: dict) -> int:
    """A job's least bytes of the monomial passes: t x 2^(n-1) amplitudes
    x 2 planes x 4 B x 2 (21 x 17.18 GB at n = 31)."""
    n, t = int(cfg["num_qubits"]), int(cfg["counting_qubits"])
    return t * (1 << (n - 1)) * roofline.PLANES * roofline.FLOAT32_BYTES * 2


def read(ctx):
    ms = monomial_ms.read(ctx)
    if not ms:
        return None
    return 100.0 * least_bytes(ctx.cfg) / roofline.HBM_BYTES_PER_S / (ms * 1e-3)
