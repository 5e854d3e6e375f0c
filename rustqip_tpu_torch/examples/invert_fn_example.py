"""Port twin of ``examples/invert_fn_example.py``: the ``@invertible``
example (qip/examples/inverse_example pattern with #[invert]): gamma then
gamma.inv is the identity, so the amplitude stays on the init state (42).

    python -m rustqip_tpu_torch.examples.invert_fn_example
"""

import numpy as np

from rustqip_tpu_torch.dsl import invertible, program
from rustqip_tpu_torch.prelude import LocalBuilder


@invertible
def gamma(b, ra, rb):
    ra, rb = b.toffoli(ra, rb)
    rb, ra = b.toffoli(rb, ra)
    return ra, rb


def main(device="cuda"):
    b = LocalBuilder(device=device)
    ra = b.register(3)
    rb = b.register(3)

    with program(b, ra=ra, rb=rb) as p:
        p.apply(gamma, p.ra[0:2], p.ra[2])
        p.apply(gamma.inv, p.ra[0:2], p.ra[2])
    ra, rb = p.results()

    state, _ = b.calculate_state_with_init([(ra, 0b101), (rb, 0b010)])
    nonzero = int(np.argmax(np.abs(state)))
    print("f . f^-1 == identity; amplitude stayed on the init state:", nonzero)
    return {"index": nonzero}


if __name__ == "__main__":
    main()
