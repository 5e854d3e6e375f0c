"""Peak rates of one NVIDIA H100 SXM and the bound arithmetic of a pass
over the port's state.

A frozen copy of ``chip_smoke.py``'s ``HBM_BYTES_PER_S``,
``TF32_FLOPS_PER_S`` and ``window_bound`` arithmetic (NVIDIA's data sheet,
dense rates, at the full 700 W power limit; the card's own limit is read
by ``card()`` and printed beside every result). It imports nothing of the
port, so a later change to the program cannot move the yardstick.
"""

from __future__ import annotations

import subprocess
from typing import Optional, Tuple

#: HBM3 bandwidth of one H100 SXM, bytes per second.
HBM_BYTES_PER_S = 3.35e12
#: Dense TF32 tensor-core rate of one H100 SXM, flops per second.
TF32_FLOPS_PER_S = 495e12
#: A float32 product in 3xTF32 takes three TF32 products (hi*hi, hi*lo, lo*hi).
TF32_PRODUCTS_PER_PRODUCT = 3
#: The port keeps a complex64 state as two float32 planes (re, im).
PLANES = 2
FLOAT32_BYTES = 4
#: Amplitudes per state row of the planes (the lane width of a window).
LANES = 128


def state_bytes(n: int) -> int:
    """Bytes of both float32 planes of an n-qubit state."""
    return PLANES * FLOAT32_BYTES << n


def pass_bound_s(n: int) -> float:
    """Least seconds of one pass over the whole state: one read and one
    write of both float32 planes at the HBM rate (1.282 ms at n = 28,
    20.51 ms at n = 32)."""
    return 2 * state_bytes(n) / HBM_BYTES_PER_S


def window_bound_s(n: int, h: int, strips_read: int, strips_written: int,
                   real_products: int = 0) -> Tuple[float, str]:
    """(least seconds, "bytes" or "operations") of one window over 2^h
    strips: the larger of the live strips read and written at the HBM rate
    and the tensor-core flops of its matrix steps in 3xTF32 at the TF32
    rate. ``real_products`` counts the real 128 x 128 products per strip
    row block (2 for a real B on both planes, 3 for a complex B by
    Karatsuba), summed over live strips, as ``chip_smoke.window_bound``
    counts them."""
    strip_rows = (1 << (n - 7)) >> h
    moved = (strips_read + strips_written) * strip_rows * LANES * FLOAT32_BYTES * PLANES
    flops = real_products * TF32_PRODUCTS_PER_PRODUCT * 2 * strip_rows * LANES * LANES
    bytes_s = moved / HBM_BYTES_PER_S
    ops_s = flops / TF32_FLOPS_PER_S
    return (bytes_s, "bytes") if bytes_s >= ops_s else (ops_s, "operations")


def card() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them
    ("NVIDIA H100 80GB HBM3, 700.00 W"), or None where it does not run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None
