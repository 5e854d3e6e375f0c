"""The general traffic generator and the job that drives the program.

A traffic mix (``traffic/<mix>.json``) is data:

- ``loop``: "closed"; ``clients``: 1 (one client sends its next job when
  the last one returned);
- ``compile``: "setup" (one circuit, drawn from the seed and compiled in
  set-up, that every job runs) or "per_job" (each job draws its own
  circuit, builds it and compiles it);
- ``input``: "uniform_basis" (a basis state drawn uniformly from the 2^n)
  or "zero";
- ``readout``: "amplitudes" (``amplitudes`` of them at indices drawn
  uniformly) or "collapse" (the first collapsing measurement's outcome
  and probability);
- ``warmup_jobs``: jobs run in set-up, from a stream of their own;
- ``check_jobs``: how many of the window's jobs the check works out again
  by the plain reference, drawn from the seed (null: every job; a
  reference's closed form, where it has one, judges every job);
- ``entry`` (optional): the name of a file ``traffic/<entry>.py`` that
  drives the job in place of this module's ``prepare`` and ``run_job``,
  for a job that enters the program another way (QASM text, the
  state-vector API). It defines both functions with these signatures,
  and may define ``KEYS`` (the further mix keys it reads) and
  ``validate(mix)`` (in place of this module's checks of ``input`` and
  ``readout``, which its mix may then leave out: a job drawn without
  ``input`` starts from index 0). It spans building and compiling with
  ``timed("compile")``, as ``run_job`` does, for ``compile_ms``.

Job i of a run with seed s draws its inputs from the stream (s, WINDOW, i)
alone, so the same seed gives the same jobs whatever the timing.

A job is one user's circuit evaluation: (build and compile,) make the
input, ``CompiledCircuit.run``, read the answer back to the host and
synchronise. It drops its planes before the next job starts.
"""

from __future__ import annotations

import importlib
import sys
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

#: Seed streams.
WINDOW, WARMUP, SETUP, CHECK, CONTROL = range(5)
MIX_KEYS = {"why", "loop", "clients", "compile", "input", "readout", "amplitudes",
            "warmup_jobs", "check_jobs", "entry"}


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), *stream]))


def validate_mix(mix: dict, entry=None) -> None:
    """Raise on a mix this generator and ``entry`` (the module that drives
    its jobs; this one by default) cannot serve."""
    entry = entry or sys.modules[__name__]
    unknown = set(mix) - MIX_KEYS - set(getattr(entry, "KEYS", ()))
    if unknown:
        raise ValueError(f"unknown traffic keys {sorted(unknown)}")
    if mix.get("loop") != "closed" or mix.get("clients") != 1:
        raise ValueError("the generator serves a closed loop of one client")
    if mix.get("compile") not in ("setup", "per_job"):
        raise ValueError(f"compile: {mix.get('compile')!r}")
    getattr(entry, "validate", validate)(mix)


def validate(mix: dict) -> None:
    """The checks of ``input`` and ``readout`` that ``run_job`` serves."""
    if mix.get("input") not in ("uniform_basis", "zero"):
        raise ValueError(f"input: {mix.get('input')!r}")
    if mix.get("readout") not in ("amplitudes", "collapse"):
        raise ValueError(f"readout: {mix.get('readout')!r}")
    if mix["readout"] == "amplitudes" and int(mix.get("amplitudes", 0)) < 1:
        raise ValueError("an amplitudes readout needs amplitudes >= 1")


@dataclass
class Job:
    index: int
    params: dict
    init: int
    read: Optional[np.ndarray]
    gen_seed: int
    answer: Optional[dict] = None
    error: Optional[str] = None
    start: float = 0.0
    end: float = 0.0
    spans: dict = field(default_factory=dict)

    @property
    def latency_s(self) -> float:
        return self.end - self.start

    def key(self):
        return (tuple(sorted(self.params.items())), self.init)


class Traffic:
    """The jobs of one run of a cell: configuration ``cfg``, mix ``mix``,
    the reference module (which draws a circuit's parameters) and the
    seed."""

    def __init__(self, cfg: dict, mix: dict, reference, seed: int, entry=None):
        self.entry = entry or sys.modules[__name__]
        validate_mix(mix, self.entry)
        self.cfg, self.mix, self.reference, self.seed = cfg, mix, reference, int(seed)
        self.n = int(cfg["num_qubits"])
        self.resident = mix["compile"] == "setup"
        self.setup_params = (reference.draw_params(cfg, rng(self.seed, SETUP))
                             if self.resident else None)

    def job(self, index: int, stream: int = WINDOW) -> Job:
        r = rng(self.seed, stream, index)
        params = self.setup_params if self.resident else self.reference.draw_params(self.cfg, r)
        init = int(r.integers(0, 1 << self.n, dtype=np.uint64)) \
            if self.mix.get("input") == "uniform_basis" else 0
        read = None
        if self.mix.get("readout") == "amplitudes":
            read = r.integers(0, 1 << self.n, size=int(self.mix["amplitudes"]), dtype=np.uint64)
        return Job(index, dict(params), init, read, int(r.integers(0, 1 << 62)))

    def check_sample(self, jobs):
        """The window's jobs the check compares."""
        k = self.mix.get("check_jobs")
        if k is None or len(jobs) <= int(k):
            return list(jobs)
        pick = rng(self.seed, CHECK).choice(len(jobs), size=int(k), replace=False)
        return [jobs[i] for i in sorted(pick)]

    def run_job(self, program, job: Job, prepared=None, annotate=None) -> None:
        """Run ``job`` through the mix's entry; ``prepared`` is what its
        ``prepare`` made in set-up for a resident mix."""
        annotate = annotate or (lambda name: nullcontext())
        self.entry.run_job(program, job, self.mix, prepared,
                           lambda name: _timed(job, name, annotate))


@contextmanager
def _timed(job: Job, name: str, annotate):
    t0 = time.perf_counter()
    with annotate(f"portbench.{name}"):
        yield
    job.spans[name] = job.spans.get(name, 0.0) + time.perf_counter() - t0


class Program:
    """The system under test for one configuration: ``rustqip_tpu_torch``'s
    ``LocalBuilder`` -> ``compile()`` -> ``CompiledCircuit.run``."""

    def __init__(self, cfg: dict, device: str, builder_kwargs: Optional[dict] = None):
        import torch

        from rustqip_tpu_torch.prelude import LocalBuilder

        self.torch = torch
        self.LocalBuilder = LocalBuilder
        self.cfg = cfg
        self.device = torch.device(device)
        self.circuit = importlib.import_module(f"portbench.circuits.{cfg['circuit']}")
        self.builder_kwargs = {"dtype": cfg["dtype"], "device": device, **(builder_kwargs or {})}

    def compile(self, params: dict):
        b = self.LocalBuilder(**self.builder_kwargs)
        self.circuit.build(b, self.cfg, params)
        return b.compile()

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)


def prepare(program: Program, params: dict):
    """Set-up of a resident mix: the circuit that every job runs."""
    return program.compile(params)


def run_job(program: Program, job: Job, mix: dict, compiled, timed) -> None:
    """Run ``job`` and put its answer on it: build and compile its circuit
    unless ``compiled`` (the set-up's) is given, make the input, run, read
    the answer back. ``timed(name)`` spans a stage on the host clock."""
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
        if mix["readout"] == "amplitudes":
            idx = torch.as_tensor(job.read.astype(np.int64), device=re.device)
            amps = torch.complex(re.reshape(-1)[idx].double(), im.reshape(-1)[idx].double())
            job.answer = {"amps": amps.cpu().numpy()}
        else:
            outcome, prob = next(r for r in results if isinstance(r, tuple))
            job.answer = {"outcome": int(outcome), "prob": float(prob)}
        del re, im, results
        program.sync()
