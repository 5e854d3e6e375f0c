"""Port twin of ``examples/inverse_example.py`` (qip/examples/
inverse_example.rs): conditioned NOT then a stochastic measurement of the
Bell pair. The state and the probabilities print as the numpy arrays that
``calculate_state`` returns.

    python -m rustqip_tpu_torch.examples.inverse_example
"""

from rustqip_tpu_torch.dsl import program
from rustqip_tpu_torch.prelude import LocalBuilder


def gamma(cb, ra):
    return cb.not_(ra)


def main(device="cuda"):
    b = LocalBuilder(device=device)

    ra = b.qubit()
    rb = b.qubit()

    ra = b.h(ra)
    with program(b, ra=ra, rb=rb) as p:
        p.control(p.ra).apply(gamma, p.rb)
    ra, rb = p.results()

    r = b.merge_two_registers(ra, rb)
    r, handle = b.measure_stochastic(r)

    state, measures = b.calculate_state()
    probs = measures.get_stochastic_measurement(handle)
    print(state)
    print(probs)
    return {"state": state, "probs": probs}


if __name__ == "__main__":
    main()
