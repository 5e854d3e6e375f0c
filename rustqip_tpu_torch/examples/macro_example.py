"""Port twin of ``examples/macro_example.py`` (qip/examples/
macro_example.rs): the program DSL's textbook-style lines with register
slices, grouping, and controls. Deterministic: depth 117, norm 1.

    python -m rustqip_tpu_torch.examples.macro_example
"""

from rustqip_tpu_torch.dsl import program
from rustqip_tpu_torch.prelude import LocalBuilder


def gamma(b, ra, rb):
    ra, rb = b.toffoli(ra, rb)
    rb, ra = b.toffoli(rb, ra)
    return ra, rb


def main(device="cuda"):
    b = LocalBuilder(device=device)
    ra = b.qudit(3)
    rb = b.qudit(3)

    with program(b, ra=ra, rb=rb) as p:
        # Applies gamma to |ra[0] ra[1]>|ra[2]>
        p.apply(gamma, p.ra[0:2], p.ra[2])
        # Applies gamma to |ra[0] rb[0]>|ra[2]> (grouped selectors)
        p.apply(gamma, (p.ra[0], p.rb[0]), p.ra[2])
        # Applies gamma to |ra[0]>|rb[0] ra[2]>
        p.apply(gamma, p.ra[0], (p.rb[0], p.ra[2]))
        # Applies gamma if rb == |111>
        p.control(p.rb).apply(gamma, p.ra[0:2], p.ra[2])
        # Applies gamma if rb == |011> (mask bit i = rb[i])
        p.control(p.rb, mask=0b110).apply(gamma, p.ra[0:2], p.ra[2])
    ra, rb = p.results()

    state, _ = b.calculate_state()
    depth = b.pipeline_depth()
    norm = float(abs(state[0]))
    print("pipeline depth:", depth)
    print("norm:", norm)
    return {"depth": depth, "norm": norm}


if __name__ == "__main__":
    main()
