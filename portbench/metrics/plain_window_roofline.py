"""Share of its bound at which the plain strip windows run, in %: the
bytes a run's plain windows must move (the program's
``observe.COUNTS["window_plain_bytes"]`` over ``["circuit_runs"]``: one
read and one write of both planes a window; every run of a resident mix
is the same circuit) at the HBM rate, over ``plain_ms``'s device time a
job. ``plain_ms`` also holds what else no kernel metric claims (the
one-hot fill, the readback), so the share can only read low, never past
100 %. None where the program keeps no such counts, or ran no plain
window."""

from portbench import roofline
from portbench.metrics import plain_ms


def read(ctx):
    try:
        from rustqip_tpu_torch.utils import observe
    except ImportError:
        return None
    counts = getattr(observe, "COUNTS", {})
    runs, moved = counts.get("circuit_runs", 0), counts.get("window_plain_bytes", 0)
    ms = plain_ms.read(ctx) if runs and moved else None
    if not ms:
        return None
    return 100.0 * moved / runs / roofline.HBM_BYTES_PER_S / (ms * 1e-3)
