"""Explicit (hand-scheduled) sharded whole-circuit executor.

Port of ``rustqip_tpu/parallel/explicit.py``. Every unitary segment is
planned once into a ``shard_ops.ShardSchedule`` (shard-local sweeps, the
window kernel on CUDA float32 shards, and the exchanges between shards),
and the measurement reductions are sums over the shards (the JAX
package's ``psum``). One process drives all shards.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from rustqip_tpu_torch.engine.admission import kernel_policy
from rustqip_tpu_torch.engine.compile import (
    CompiledCircuit,
    MeasureEntry,
    PipelineEntry,
    _norm_check_cb,
)
from rustqip_tpu_torch.engine.fusion import DEFAULT_MAX_FUSED_QUBITS
from rustqip_tpu_torch.engine.real_apply import butterfly_eligible, window_joint_ok
from rustqip_tpu_torch.errors import CircuitError
from rustqip_tpu_torch.ops.measurement_ops import (
    measure_probs_ri,
    measure_state_ri,
    sample_outcome,
)
from rustqip_tpu_torch.parallel.shard_ops import (
    ShardSchedule,
    _basis_shards,
    _local_op,
    _mesh_geometry,
    _shard_bit,
)
from rustqip_tpu_torch.types import TORCH_REAL, geometry, real_dtype_of


def _split_measured(g: int, indices):
    """Measured qubits split into global ``(i, q)`` and local ``(i, q)``
    pairs (``i`` the outcome bit), and the spread of a local outcome onto
    the full outcome's bits."""
    gmeas = [(i, q) for i, q in enumerate(indices) if q < g]
    lmeas = [(i, q) for i, q in enumerate(indices) if q >= g]
    t = np.arange(1 << len(lmeas), dtype=np.int64)
    spread = np.zeros(1 << len(lmeas), np.int64)
    for j, (i, _) in enumerate(lmeas):
        spread |= ((t >> j) & 1) << i
    return gmeas, lmeas, spread


def _probs_over(devices, g: int, n: int, indices, re, im) -> torch.Tensor:
    local_n = n - g
    indices = tuple(int(i) for i in indices)
    k = len(indices)
    gmeas, lmeas, spread = _split_measured(g, indices)
    local_idx = [q - g for _, q in lmeas]
    dev0 = devices[0]
    spread_t = torch.as_tensor(spread, device=dev0)
    full = torch.zeros(1 << k, dtype=re[0].dtype, device=dev0)
    for my, (r, i) in enumerate(zip(re, im)):
        if local_idx:
            lp = measure_probs_ri(local_n, local_idx, r, i)
        else:
            lp = torch.sum(r * r + i * i).reshape(1)
        base = 0
        for i_out, q in gmeas:
            base |= _shard_bit(my, g, q) << i_out
        full.index_add_(0, spread_t + base, lp.to(dev0))
    return full


def sharded_measure_probs_ri(mesh, n: int, indices, re, im) -> torch.Tensor:
    """Outcome distribution of measuring ``indices`` on a sharded state:
    shard-local reductions, each scattered into the 2^k outcome vector,
    then the sum over shards; on shard 0's device."""
    _, _, g = _mesh_geometry(mesh)
    return _probs_over(mesh.devices, g, n, indices, re, im)


def _collapse_over(g: int, n: int, indices, measured, re, im):
    local_n = n - g
    indices = tuple(int(i) for i in indices)
    outcome, prob = int(measured[0]), float(measured[1])
    if not prob > 0:
        return list(re), list(im)
    gmeas, lmeas, _ = _split_measured(g, indices)
    local_idx = [q - g for _, q in lmeas]
    louts = 0
    for j, (i_out, _) in enumerate(lmeas):
        louts |= ((outcome >> i_out) & 1) << j
    _, R_l, C_l = geometry(local_n)
    out_r, out_i = [], []
    for my, (r, i) in enumerate(zip(re, im)):
        active = all(
            _shard_bit(my, g, q) == (outcome >> i_out) & 1 for i_out, q in gmeas
        )
        if not active:
            out_r.append(torch.zeros_like(r))
            out_i.append(torch.zeros_like(i))
        elif local_idx:
            cr, ci = measure_state_ri(local_n, local_idx, (louts, prob), r, i)
            out_r.append(cr)
            out_i.append(ci)
        else:
            np_dt = np.float32 if r.dtype == torch.float32 else np.float64
            tiny = float(torch.finfo(r.dtype).tiny)
            scale = float(1.0 / np.sqrt(max(np.asarray(prob, dtype=np_dt), tiny)))
            out_r.append((r * scale).reshape(R_l, C_l))
            out_i.append((i * scale).reshape(R_l, C_l))
    return out_r, out_i


def sharded_measure_state_ri(mesh, n: int, indices, measured, re, im):
    """Collapse a sharded state onto ``(outcome, prob)`` with rescale
    1/sqrt(p): no exchange (each shard knows its index bits; shards whose
    global bits disagree with the outcome become zero)."""
    _, _, g = _mesh_geometry(mesh)
    return _collapse_over(g, n, indices, measured, re, im)


def gather_state(re: Sequence[torch.Tensor], im: Sequence[torch.Tensor]) -> np.ndarray:
    """The host complex state vector of a sharded state (complex64 for
    float32 shards, complex128 for float64)."""
    vr = np.concatenate([r.detach().cpu().numpy().reshape(-1) for r in re])
    vi = np.concatenate([i.detach().cpu().numpy().reshape(-1) for i in im])
    dt = np.complex64 if vr.dtype == np.float32 else np.complex128
    state = vr.astype(dt)
    state.imag = vi
    return state


class _ShardedCircuitBase(CompiledCircuit):
    """A CompiledCircuit whose state is ``(re, im)`` shard lists over the
    flattened devices of ``mesh``; each unitary segment is a
    ``ShardSchedule`` planned at compile time."""

    def __init__(self, n, entries, dtype, mesh, g, fuse, max_fused_qubits,
                 check_norm, kernel_ok):
        self.mesh = mesh
        self._g = g
        self._devices = tuple(mesh.devices)
        if n < g:
            raise CircuitError(
                f"Need at least {g} qubits to shard over {mesh.size} devices"
            )
        # Every shard holds a plain local (rows, 128) view, so shard-local
        # runs take the kernels as one device would: the policy of the
        # shard devices.
        kernel_ok = kernel_policy(self._devices, TORCH_REAL[real_dtype_of(dtype)], kernel_ok)
        super().__init__(
            n, entries, dtype, fuse, max_fused_qubits, device=self._devices[0],
            kernel_ok=kernel_ok, check_norm=check_norm,
        )

    def _compile_segment(self, seg):
        if isinstance(seg, MeasureEntry):
            return seg
        if isinstance(seg, tuple):
            return ("repeat", seg[1], self._schedule(seg[2]))
        return self._schedule(seg)

    def _schedule(self, ops) -> ShardSchedule:
        return ShardSchedule(self._devices, self.n, ops, self._kernel_ok)

    def sweep_counts(self) -> Dict[str, int]:
        """Executed sweeps by kind over all shards (``ShardSchedule``),
        repeat bodies counted once per repetition."""
        counts: Dict[str, int] = {"kwindow": 0, "window": 0, "op": 0}
        for s in self.sweeps:
            if isinstance(s, MeasureEntry):
                continue
            times, sched = (s[1], s[2]) if isinstance(s, tuple) else (1, s)
            for kind, c in sched.sweep_counts().items():
                counts[kind] += times * c
        return counts

    def _one_hot(self, initial_index: int):
        return _basis_shards(self._devices, self.n, self._g, initial_index,
                             self.rdtype)

    def _from_state(self, initial_state) -> tuple:
        _, R_l, C_l = geometry(self.n - self._g)
        arr = np.asarray(initial_state).reshape(len(self._devices), R_l, C_l)
        td = TORCH_REAL[self.rdtype]
        re = [torch.as_tensor(np.ascontiguousarray(a.real), dtype=td).to(dev)
              for a, dev in zip(arr, self._devices)]
        im = [torch.as_tensor(np.ascontiguousarray(a.imag), dtype=td).to(dev)
              for a, dev in zip(arr, self._devices)]
        return re, im

    def run(
        self,
        initial_index: int = 0,
        generator: Optional[torch.Generator] = None,
        initial_state: Optional[np.ndarray] = None,
        forced: Optional[dict] = None,
    ):
        """Execute; returns ``(re_shards, im_shards, results)``: lists of
        the shards' (R, C) planes in shard order, and the results as
        ``CompiledCircuit.run`` gives them (probabilities on shard 0's
        device)."""
        if generator is None:
            generator = torch.Generator()
            generator.manual_seed(int(np.random.randint(0, 2**31 - 1)))
        fmask, fvals, fpmask, fprobs = self._forced_arrays(
            forced or {}, self.num_measurements
        )
        if initial_state is not None:
            re, im = self._from_state(initial_state)
        else:
            re, im = self._one_hot(initial_index)
        results: List = []
        m_i = 0
        for s_i, seg in enumerate(self.sweeps):
            if isinstance(seg, MeasureEntry):
                probs = _probs_over(self._devices, self._g, self.n, seg.indices, re, im)
                if seg.stochastic:
                    results.append(probs)
                else:
                    outcome = sample_outcome(probs, generator)
                    if fmask[m_i]:
                        outcome = int(fvals[m_i])
                    prob = float(probs[outcome])
                    if fpmask[m_i]:
                        prob = float(np.asarray(fprobs[m_i], dtype=self.rdtype))
                    re, im = _collapse_over(
                        self._g, self.n, seg.indices, (outcome, prob), re, im
                    )
                    results.append((outcome, prob))
                m_i += 1
            elif isinstance(seg, tuple):
                re, im = seg[2].run(re, im, times=seg[1])
            else:
                re, im = seg.run(re, im)
            if self._check_norm:
                dev0 = self._devices[0]
                total = sum(torch.sum(r * r + i * i).to(dev0) for r, i in zip(re, im))
                _norm_check_cb(total, s_i, self._norm_tol)
        return re, im, tuple(results)

    def run_complex(
        self,
        initial_index: int = 0,
        generator: Optional[torch.Generator] = None,
        initial_state: Optional[np.ndarray] = None,
        forced: Optional[dict] = None,
    ):
        """Execute and gather the final state as a host complex array."""
        re, im, results = self.run(initial_index, generator, initial_state, forced)
        state = gather_state(re, im)
        if self.dtype == np.dtype(np.complex128):
            state = state.astype(np.complex128)
        return state, results


class ExplicitShardedCircuit(_ShardedCircuitBase):
    """A CompiledCircuit run through the hand-scheduled exchange path on a
    1-D mesh; shard-local runs take the window kernel on CUDA float32
    shards."""

    def __init__(
        self,
        n: int,
        entries: Sequence[PipelineEntry],
        dtype,
        mesh,
        fuse: bool = True,
        max_fused_qubits: int = DEFAULT_MAX_FUSED_QUBITS,
        check_norm: bool = False,
        kernel_ok: Optional[bool] = None,
    ):
        _, _, g = _mesh_geometry(mesh)
        super().__init__(n, entries, dtype, mesh, g, fuse, max_fused_qubits,
                         check_norm, kernel_ok)

    def _fusion_keep(self):
        """Butterfly keep-predicate in the shard-local qubit space: only
        fully local ops can take the per-shard kernel, and eligibility is
        judged against the shard's own (rows, 128) view."""
        g, local_n, adm = self._g, self.n - self._g, self.admission
        return lambda op: (
            min(op.indices) >= g
            and butterfly_eligible(local_n, _local_op(op, g), adm)
        )

    def _fusion_joint_ok(self):
        """Greedy-joint cap in the shard-local space. Joints touching
        global qubits lower through exchange schedules where window shapes
        do not matter: they keep plain greedy fusion."""
        g = self._g
        local_ok = window_joint_ok(self.n - g, self.admission)
        if local_ok is None:
            return None

        def joint_ok(indices):
            if min(indices) < g:
                return True
            return local_ok(tuple(q - g for q in indices))

        return joint_ok


_CACHE: Dict[tuple, ExplicitShardedCircuit] = {}


def mesh_key(mesh) -> tuple:
    """A mesh's identity for compile caches: each shard's device type and
    index, the shape and the axis names."""
    return (
        tuple((d.type, d.index) for d in mesh.devices),
        tuple(mesh.shape),
        tuple(mesh.axis_names),
    )


def compile_sharded_explicit(
    n: int,
    entries: Sequence[PipelineEntry],
    dtype,
    mesh,
    fuse: bool = True,
    max_fused_qubits: int = DEFAULT_MAX_FUSED_QUBITS,
    check_norm: bool = False,
    kernel_ok: Optional[bool] = None,
) -> ExplicitShardedCircuit:
    """Compile (with caching) a lowered pipeline for the explicit executor.
    ``kernel_ok`` as for ``compile_pipeline`` (None: the policy)."""
    dtype = np.dtype(dtype)
    fp = (
        n,
        dtype.str,
        fuse,
        max_fused_qubits,
        bool(check_norm),
        kernel_ok,
        mesh_key(mesh),
        tuple(e.fingerprint() for e in entries),
    )
    cached = _CACHE.get(fp)
    if cached is None:
        cached = ExplicitShardedCircuit(
            n, entries, dtype, mesh, fuse, max_fused_qubits,
            check_norm=bool(check_norm), kernel_ok=kernel_ok,
        )
        _CACHE[fp] = cached
    return cached
