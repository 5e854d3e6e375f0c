"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It measures ``rustqip_tpu_torch`` on one
CUDA card: set-up (import, CUDA start, the kernels' libraries, built into
``build/rustqip_tpu_torch/`` by the first run in a checkout, the resident
circuit, warm-up jobs), then jobs in a closed loop of one client for
``--seconds``, then the check against the plain reference. The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics, read from a ``torch.profiler`` trace
of the window), ``device``, with ``--trace 1`` a ``breakdown``, the card's
name and power limit, and last the numbers compared beside their limits,
which also end standard error.

Exit codes: 0 a result was printed (correct or not); 2 no CUDA card, or
fewer than the cell asks for; 3 the program cannot be imported; 4 JAX or
the JAX package was loaded in this process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: Top-level modules that may not be loaded in the process that prints.
FORBIDDEN = ("jax", "jaxlib", "flax", "rustqip_tpu")


def forbidden_modules():
    """Forbidden top-level names in ``sys.modules``, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache a library may write stays in the checkout, at fixed paths
    cache = ROOT / "build" / "portbench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    sys.path[0] = str(ROOT)  # the checkout, in place of this script's folder

    from portbench import harness

    cell = harness.load_cell(args.workload, ROOT)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import rustqip_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: cannot import the program: {e}", file=sys.stderr)
        return 3

    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              device="cuda", t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 4
    if result["card"]:
        print(f"card: {result['card']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
