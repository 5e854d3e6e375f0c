"""Port twin of ``examples/grover_example.py``: Grover search over 12
qubits, the JAX package's benchmark flagship (BASELINE.json config 2):
oracle + diffusion rounds as a repeat block, stochastic readout of the
marked element. On the card the admission may plan other fused passes
than the JAX package's (its TPU admission).

    python -m rustqip_tpu_torch.examples.grover_example
"""

import numpy as np

from rustqip_tpu_torch.algos import grover_search
from rustqip_tpu_torch.prelude import LocalBuilder
from rustqip_tpu_torch.utils.observe import circuit_stats


def main(device="cuda"):
    n, marked = 12, 0b101101011001
    b = LocalBuilder(dtype="f32", device=device)
    _, handle = grover_search(b, n, marked)
    stats = circuit_stats(b)
    print(stats)
    _, measured = b.calculate_state(seed=0)
    probs = measured.get_stochastic_measurement(handle)
    found = int(np.argmax(probs))
    print(f"marked={marked:#014b} found={found:#014b} p={probs[found]:.4f}")

    # Same search with the native reflection diffusion (2|s><s| - I as one
    # reduction + elementwise pass instead of 2n+2 gate passes per round);
    # the outcome distribution is identical.
    b2 = LocalBuilder(dtype="f32", device=device)
    _, h2 = grover_search(b2, n, marked, native_diffusion=True)
    stats2 = circuit_stats(b2)
    print(stats2)
    _, m2 = b2.calculate_state(seed=0)
    p2 = m2.get_stochastic_measurement(h2)
    f2 = int(np.argmax(p2))
    print(f"native diffusion: found={f2:#014b} p={p2[f2]:.4f}")
    assert f2 == found
    return {"stats": (stats, stats2), "found": (found, f2),
            "p": (float(probs[found]), float(p2[f2]))}


if __name__ == "__main__":
    main()
