"""The job of a mix whose answer is a whole outcome distribution: the
first stochastic measurement's probabilities, which ``jobs.run_job`` does
not read back (it serves amplitudes and collapse readouts).

A job runs the compiled circuit from |0...0> (the set-up's, or its own
where the mix compiles per job), reads the measurement's 2^m
probabilities back to the host, and synchronises. Anything drawn from
them, such as Shor's continued-fraction step, stays out of the job.
"""

import numpy as np


def validate(mix: dict) -> None:
    if mix.get("input") != "zero":
        raise ValueError(f"input: {mix.get('input')!r} (a distribution job starts at |0...0>)")
    if mix.get("readout") != "distribution":
        raise ValueError(f"readout: {mix.get('readout')!r}")


def prepare(program, params: dict):
    """Set-up of a resident mix: the circuit that every job runs."""
    return program.compile(params)


def run_job(program, job, mix: dict, compiled, timed) -> None:
    torch = program.torch
    cc = compiled
    if cc is None:
        with timed("compile"):
            cc = program.compile(job.params)
    gen = torch.Generator()
    gen.manual_seed(job.gen_seed)
    with timed("run"):
        re, im, results = cc.run(job.init, generator=gen)
    with timed("readback"):
        probs = next(r for r in results if not isinstance(r, tuple))
        job.answer = {"probs": np.asarray(probs.cpu().numpy())}
        del re, im, results, probs
        program.sync()
