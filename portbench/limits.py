"""Readings that the limits of the check are set from (not part of a run).

    python3 portbench/limits.py --workload <cell> --seeds 1,2,... --seconds 4 \
        --control-seeds 7,8,9

For each of ``--seeds`` it runs the cell as ``run.py`` does (set-up, a
window of ``--seconds``, the check) in this one process and prints the
numbers compared: the program's readings, the lower end of each limit.
For each of ``--control-seeds`` it puts the reference, computed in TF32,
in the program's place on the jobs a run of that seed would judge
(``--control-jobs`` of them, sampled as the mix's ``check_jobs`` says) and
prints the same numbers: the control's readings, which must fail a limit.
One JSON line each.

``--plant <fault>`` plants a fault in the program before the program's
seeds run (``PLANTS``), to read what the check makes of it on the card:
``tf32_b`` zeroes the low TF32 part of the matrix operand B that the tile
path's 3xTF32 products stream (``window_kernel.tf32_split``), so every
matrix step multiplies by B rounded to TF32.
"""

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_numbers(name, seed, n_jobs, device, cfg_overrides=None, root=ROOT):
    """(worst numbers, correct) of the TF32 reference in the program's
    place on the first ``n_jobs`` jobs of a run of ``seed``."""
    from portbench import check, harness, jobs
    from portbench.reference.precision import TF32

    cell = harness.load_cell(name, root, cfg_overrides)
    traffic = jobs.Traffic(cell.cfg, cell.mix, cell.reference, seed, cell.entry)
    judged = traffic.check_sample([traffic.job(i) for i in range(int(n_jobs))])
    refs = {}

    def answer(job):
        key = job.key()
        if key not in refs:
            refs[key] = cell.reference.solve(cell.cfg, job.params, job.init, TF32, device)
        a = cell.reference.control_answer(cell.cfg, refs[key], job,
                                          jobs.rng(seed, jobs.CONTROL, job.index))
        return dataclasses.replace(job, answer=a)

    worst = check.worst_numbers(cell.cfg, cell.reference, judged, device, answer, every=judged)
    correct, checks = check.verdict(cell.reference, worst, len(judged), 0)
    return checks, correct


def _plant_tf32_b():
    import numpy as np

    from rustqip_tpu_torch.engine import window_kernel

    def split(x):
        hi = window_kernel.tf32_round(np.asarray(x, dtype=np.float32))
        return hi, np.zeros_like(hi)

    window_kernel.tf32_split = split


#: Faults ``--plant`` can plant in the program, by name.
PLANTS = {"tf32_b": _plant_tf32_b}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--control-jobs", type=int, default=60)
    ap.add_argument("--plant", choices=sorted(PLANTS))
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)  # the checkout, in place of this script's folder
    import torch

    from portbench import harness

    device = "cuda" if torch.cuda.is_available() else "cpu"
    if args.plant:
        PLANTS[args.plant]()
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        r = harness.run_cell(args.workload, seed, args.seconds, False, device=device)
        print(json.dumps({"workload": args.workload, "side": args.plant or "program",
                          "seed": seed,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "failed": r["failed"], "checks": r["checks"],
                          "metrics": r["metrics"], "card": r["card"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        t0 = time.perf_counter()
        checks, correct = control_numbers(args.workload, seed, args.control_jobs, device)
        print(json.dumps({"workload": args.workload, "side": "control_tf32", "seed": seed,
                          "correct": correct, "checks": checks,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
