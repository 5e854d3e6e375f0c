"""Circuit compilation: pipeline -> planned sweeps, run eagerly.

Port of ``rustqip_tpu/engine/compile.py``. The JAX package traces the whole
pipeline into one ``jax.jit`` program; PyTorch runs eagerly, so the port
does all host work once, at compile time: swap deferral, fusion, segment
split, sweep planning and the encoding of every kernel window, whose step
program is uploaded to the circuit's device. ``run()`` then only executes
sweeps and measurements; repeat blocks are a Python loop over the same
planned body.

Compiled circuits are cached by a structural fingerprint of the pipeline
plus the device, dtype and kernel policy. The JAX package's
``RUSTQIP_TPU_*`` knobs are not read: their defaults are hard-wired.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from rustqip_tpu_torch.engine import relabel
from rustqip_tpu_torch.engine.admission import for_device
from rustqip_tpu_torch.engine.apply import _geometry
from rustqip_tpu_torch.engine.fusion import DEFAULT_MAX_FUSED_QUBITS, fuse_ops
from rustqip_tpu_torch.engine.real_apply import (
    butterfly_eligible,
    compile_sweeps,
    run_sweeps,
    window_joint_ok,
)
from rustqip_tpu_torch.errors import CircuitError
from rustqip_tpu_torch.ops.matrix_ops import MatrixOp, op_fingerprint
from rustqip_tpu_torch.ops.measurement_ops import (
    measure_probs_ri,
    measure_state_ri,
    sample_outcome,
)
from rustqip_tpu_torch.types import TORCH_REAL, real_dtype_of


@dataclass(frozen=True)
class UnitaryEntry:
    """A lowered gate op in the executable pipeline."""

    op: MatrixOp

    def fingerprint(self):
        return ("u", op_fingerprint(self.op))


@dataclass(frozen=True)
class MeasureEntry:
    """A measurement: ``stochastic=True`` returns the outcome distribution
    without collapsing; otherwise sample-and-collapse."""

    indices: Tuple[int, ...]
    stochastic: bool = False

    def fingerprint(self):
        return ("m", self.indices, self.stochastic)


@dataclass(frozen=True)
class RepeatEntry:
    """A unitary block applied ``times`` times (planned once)."""

    times: int
    entries: Tuple["PipelineEntry", ...]

    def fingerprint(self):
        return ("rep", self.times, tuple(e.fingerprint() for e in self.entries))


PipelineEntry = Union[UnitaryEntry, MeasureEntry, RepeatEntry]


class CompiledCircuit:
    """An executable circuit on one device."""

    def __init__(
        self,
        n: int,
        entries: Sequence[PipelineEntry],
        dtype,
        fuse: bool = True,
        max_fused_qubits: int = DEFAULT_MAX_FUSED_QUBITS,
        device="cuda",
        kernel_ok: Optional[bool] = None,
    ):
        self.n = n
        self.dtype = np.dtype(dtype)
        self.rdtype = real_dtype_of(self.dtype)
        self.device = torch.device(device)
        self.entries = list(entries)
        self.num_measurements = sum(
            1 for e in self.entries if isinstance(e, MeasureEntry)
        )
        #: Whether unitary runs take the window kernel: by default when the
        #: state lives on CUDA; never for float64 (the JAX package's rule).
        if kernel_ok is None:
            kernel_ok = self.device.type == "cuda"
        self._kernel_ok = bool(kernel_ok) and self.rdtype == np.float32
        #: Kernel admission: the Hopper rules for a CUDA state, the
        #: reference's elsewhere. Fusion and planning read the same object.
        self.admission = for_device(self.device)
        self.segments = self._plan(fuse, max_fused_qubits)
        self.sweeps = [self._compile_segment(s) for s in self.segments]

    # -- planning ----------------------------------------------------------
    def _plan(self, fuse: bool, max_fused_qubits: int):
        """Split the pipeline into unitary runs (fused) and measurements,
        with swaps deferred into an index relabeling (``relabel.py``)."""
        pos = list(range(self.n))
        segments: List = []
        run: List[MatrixOp] = []
        keep = joint_ok = None
        if self._kernel_ok:
            n, adm = self.n, self.admission
            keep = lambda op: butterfly_eligible(n, op, adm)  # noqa: E731
            joint_ok = window_joint_ok(n, adm)

        def fused(ops):
            if not fuse:
                return list(ops)
            return fuse_ops(ops, max_fused_qubits, keep=keep, joint_ok=joint_ok)

        def flush():
            nonlocal run
            if run:
                segments.append(fused(run))
                run = []

        def flush_perm():
            nonlocal pos
            run.extend(relabel.materialize(pos))
            pos = list(range(self.n))

        for e in self.entries:
            if isinstance(e, UnitaryEntry):
                run.extend(relabel.defer_swaps_ops(self.n, [e.op], pos))
            elif isinstance(e, RepeatEntry):
                flush_perm()
                flush()
                body_ops = []
                for be in e.entries:
                    if not isinstance(be, UnitaryEntry):
                        raise TypeError("RepeatEntry bodies must be purely unitary")
                    body_ops.append(be.op)
                bpos = list(range(self.n))
                body_ops = relabel.defer_swaps_ops(self.n, body_ops, bpos)
                body_ops.extend(relabel.materialize(bpos))
                segments.append(("repeat", e.times, fused(body_ops)))
            else:
                if pos != list(range(self.n)):
                    e = MeasureEntry(tuple(pos[q] for q in e.indices), e.stochastic)
                flush()
                segments.append(e)
        flush_perm()
        flush()
        return segments

    def _compile_segment(self, seg):
        if isinstance(seg, MeasureEntry):
            return seg
        ops = seg[2] if isinstance(seg, tuple) else seg
        sweeps = compile_sweeps(
            self.n, ops, self._kernel_ok, self.admission, self.device
        )
        if isinstance(seg, tuple):
            return ("repeat", seg[1], sweeps)
        return sweeps

    @property
    def num_passes(self) -> int:
        """Executed gate passes after fusion (circuit stats), repeat bodies
        counted once per repetition (JAX ``compile.py``:295)."""
        total = 0
        for s in self.segments:
            if isinstance(s, MeasureEntry):
                continue
            if isinstance(s, tuple):
                total += s[1] * len(s[2])
            else:
                total += len(s)
        return total

    @property
    def num_sweeps(self) -> int:
        """Executed state sweeps (read + write of the planes): the sweeps of
        this circuit's own plan, with its admission and kernel policy, so
        it is what ``run`` executes (JAX ``compile.py``:308 counts the
        plain window collection; ``num_passes`` counts fused gate ops)."""
        return sum(self.sweep_counts().values())

    def sweep_counts(self) -> Dict[str, int]:
        """Executed sweeps by kind ("kwindow"/"window"/"op"), repeat
        bodies counted once per repetition."""
        counts: Dict[str, int] = {"kwindow": 0, "window": 0, "op": 0}
        for s in self.sweeps:
            if isinstance(s, MeasureEntry):
                continue
            times, body = (s[1], s[2]) if isinstance(s, tuple) else (1, s)
            for kind, _p, _r in body:
                counts[kind] += times
        return counts

    # -- execution ---------------------------------------------------------
    def _one_hot(self, initial_index: int):
        initial_index = int(initial_index)
        if not 0 <= initial_index < (1 << self.n):
            raise CircuitError(
                f"initial_index {initial_index} out of range for {self.n} qubits"
            )
        _, R, C = _geometry(self.n)
        row, col = divmod(initial_index, C)
        td = TORCH_REAL[self.rdtype]
        re = torch.zeros((R, C), dtype=td, device=self.device)
        re[row, col] = 1.0
        return re, torch.zeros_like(re)

    @staticmethod
    def _forced_arrays(forced: dict, num_measurements: int):
        """Normalize {ordinal: outcome | (outcome, prob|None)} into the four
        forcing arrays (mask, vals, pmask, probs)."""
        size = max(num_measurements, 1)
        mask = np.zeros(size, dtype=bool)
        vals = np.zeros(size, dtype=np.int64)
        pmask = np.zeros(size, dtype=bool)
        probs = np.zeros(size, dtype=np.float64)
        for ordinal, spec in forced.items():
            prob = None
            if isinstance(spec, tuple):
                outcome, prob = spec
            else:
                outcome = spec
            mask[ordinal] = True
            vals[ordinal] = int(outcome)
            if prob is not None:
                pmask[ordinal] = True
                probs[ordinal] = float(prob)
        return mask, vals, pmask, probs

    def run(
        self,
        initial_index: int = 0,
        generator: Optional[torch.Generator] = None,
        initial_state: Optional[np.ndarray] = None,
        forced: Optional[dict] = None,
    ):
        """Execute; returns ``(re, im, results)`` with (R, C) planes on the
        circuit's device. ``results`` holds ``(outcome, prob)`` for
        collapsing measurements and a probability tensor for stochastic
        ones. ``forced`` maps measurement ordinal -> outcome or
        ``(outcome, prob)`` (the MeasuredCondition path)."""
        if generator is None:
            generator = torch.Generator()
            generator.manual_seed(int(np.random.randint(0, 2**31 - 1)))
        fmask, fvals, fpmask, fprobs = self._forced_arrays(
            forced or {}, self.num_measurements
        )
        _, R, C = _geometry(self.n)
        if initial_state is not None:
            arr = np.asarray(initial_state).reshape(R, C)
            td = TORCH_REAL[self.rdtype]
            re = torch.as_tensor(np.ascontiguousarray(arr.real), dtype=td).to(self.device)
            im = torch.as_tensor(np.ascontiguousarray(arr.imag), dtype=td).to(self.device)
        else:
            re, im = self._one_hot(initial_index)
        results: List = []
        m_i = 0
        for seg in self.sweeps:
            if isinstance(seg, MeasureEntry):
                probs = measure_probs_ri(self.n, seg.indices, re, im)
                if seg.stochastic:
                    results.append(probs)
                else:
                    outcome = sample_outcome(probs, generator)
                    if fmask[m_i]:
                        outcome = int(fvals[m_i])
                    prob = float(probs[outcome])
                    if fpmask[m_i]:
                        prob = float(np.asarray(fprobs[m_i], dtype=self.rdtype))
                    re, im = measure_state_ri(
                        self.n, seg.indices, (outcome, prob), re, im
                    )
                    results.append((outcome, prob))
                m_i += 1
            elif isinstance(seg, tuple):
                for _ in range(seg[1]):
                    re, im = run_sweeps(self.n, seg[2], re, im)
            else:
                re, im = run_sweeps(self.n, seg, re, im)
        return re, im, tuple(results)

    def run_complex(
        self,
        initial_index: int = 0,
        generator: Optional[torch.Generator] = None,
        initial_state: Optional[np.ndarray] = None,
        forced: Optional[dict] = None,
    ):
        """Execute and fetch the final state as a host complex array."""
        re, im, results = self.run(initial_index, generator, initial_state, forced)
        state = re.cpu().numpy().astype(np.complex128).reshape(-1)
        state = state + 1j * im.cpu().numpy().reshape(-1)
        if self.dtype == np.dtype(np.complex64):
            state = state.astype(np.complex64)
        return state, results


_CACHE: Dict[tuple, CompiledCircuit] = {}


def compile_pipeline(
    n: int,
    entries: Sequence[PipelineEntry],
    dtype,
    fuse: bool = True,
    max_fused_qubits: int = DEFAULT_MAX_FUSED_QUBITS,
    device="cuda",
    kernel_ok: Optional[bool] = None,
) -> CompiledCircuit:
    """Compile (with caching) a lowered pipeline into a CompiledCircuit."""
    dtype = np.dtype(dtype)
    dev = torch.device(device)
    fp = (
        n,
        dtype.str,
        fuse,
        max_fused_qubits,
        str(dev),
        kernel_ok,
        tuple(e.fingerprint() for e in entries),
    )
    cached = _CACHE.get(fp)
    if cached is None:
        cached = CompiledCircuit(
            n, entries, dtype, fuse, max_fused_qubits, dev, kernel_ok
        )
        _CACHE[fp] = cached
    return cached
