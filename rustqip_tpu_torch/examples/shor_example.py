"""Port twin of ``examples/shor_example.py``: Shor's algorithm factors 15
by quantum period finding. Both results are deterministic: they
post-process the outcome distribution.

    python -m rustqip_tpu_torch.examples.shor_example
"""

from rustqip_tpu_torch.algos import factor, find_period


def main(device="cuda"):
    period = find_period(7, 15, device=device)
    print("period of 7 mod 15:", period)
    factors = factor(15, device=device)
    print("factor(15):", factors)
    return {"period": period, "factors": factors}


if __name__ == "__main__":
    main()
