"""Port twin of ``examples/simple.py``: the CSWAP (swap test) example, the
reference's README circuit (qip/examples/simple.rs): H, conditioned
register swap, H, measure.

The outcome is drawn by a ``torch.Generator``; the printed chance is
deterministic (0.5).

    python -m rustqip_tpu_torch.examples.simple
"""

from rustqip_tpu_torch.prelude import LocalBuilder


def main(device="cuda"):
    b = LocalBuilder(device=device)

    # Three registers of sizes 1, 3, 3 (7 qubits total).
    q = b.qubit()
    ra = b.register(3)
    rb = b.register(3)

    # H on the probe, swap ra/rb conditioned on it, H again.
    q = b.h(q)
    cb = b.condition_with(q)
    ra, rb = cb.swap(ra, rb)
    q = cb.dissolve()
    q = b.h(q)

    # Measure the probe; keep the handle to read the result later.
    q, m_handle = b.measure(q)

    # Run with |ra> = |000>, |rb> = |001>.
    _, measured = b.calculate_state_with_init([(ra, 0b000), (rb, 0b001)])

    result, p = measured.get_measurement(m_handle)
    print(f"Measured: {result} (with chance {p})")
    return {"outcome": result, "chance": p}


if __name__ == "__main__":
    main()
