"""The comparison that decides ``correct``.

After the window has closed, the jobs the mix's ``check_jobs`` names (all,
or a sample drawn from the seed) are judged against the configuration's
plain reference (``reference/<circuit>.py``), which works each answer out
again from the job's inputs: one ``solve`` per distinct circuit and input.
Where the reference also knows a closed form of the answer
(``closed_numbers``), every answered job of the window is judged by it
too. Each number compared is the worst over those jobs and is held to
its limit. A job that raised never answered, and makes the run not
correct.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

from portbench.reference.precision import EXACT


def worst_numbers(cfg: dict, reference, jobs: Sequence, device,
                  answer: Optional[Callable] = None,
                  every: Sequence = ()) -> Dict[str, float]:
    """The worst of each of ``reference.numbers`` over ``jobs`` and of
    ``reference.closed_numbers`` (where it has them) over ``every``. With
    ``answer(job)``, the judged answers are those of the job it returns
    (the control's) instead of the program's."""
    refs: dict = {}
    worst: Dict[str, float] = {}

    def keep(numbers):
        for name, value in numbers.items():
            worst[name] = max(worst.get(name, float("-inf")), float(value))

    for job in jobs:
        key = job.key()
        if key not in refs:
            refs[key] = reference.solve(cfg, job.params, job.init, EXACT, device)
        keep(reference.numbers(cfg, refs[key], job if answer is None else answer(job)))
    closed = getattr(reference, "closed_numbers", None)
    for job in every if closed else ():
        keep(closed(cfg, job if answer is None else answer(job)))
    return worst


def verdict(reference, worst: Dict[str, float], n_compared: int, n_failed: int):
    """(correct, {name: {"value", "limit"}}) of a run."""
    checks = {name: {"value": worst[name], "limit": limit}
              for name, limit in reference.LIMITS.items() if name in worst}
    correct = (n_failed == 0 and n_compared > 0 and len(checks) == len(reference.LIMITS)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    return correct, checks
