"""Port twin of ``examples/phase_estimation_example.py``: quantum phase
estimation reads the eigenphase of a single-qubit rotation to 6 bits. The
circuit is float64, so it runs the plain torch passes (no kernel).

    python -m rustqip_tpu_torch.examples.phase_estimation_example
"""

import numpy as np

from rustqip_tpu_torch.algos import estimate_phase
from rustqip_tpu_torch.prelude import LocalBuilder


def main(device="cuda"):
    phi = 21 / 64  # exactly representable in 6 phase bits
    u = np.diag([1.0, np.exp(2j * np.pi * phi)])

    b = LocalBuilder(dtype="f64", device=device)
    got, prob = estimate_phase(
        b, u, m=6, prepare=lambda bb, t: bb.x(t), seed=0
    )
    print(f"true phase:      {phi}")
    print(f"estimated phase: {got} (certainty {prob:.6f})")
    assert got == phi
    return {"phase": got, "certainty": prob}


if __name__ == "__main__":
    main()
