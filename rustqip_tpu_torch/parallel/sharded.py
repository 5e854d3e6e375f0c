"""Sharded whole-circuit execution over meshes of any shape.

Port of ``rustqip_tpu/parallel/sharded.py``. The JAX package's
``ShardedCircuit`` lets XLA's GSPMD partition the engine code over the
mesh; torch has no GSPMD, so the port's counterpart runs the same
hand-made shard schedule as the explicit executor with the kernel policy
off (plain greedy fusion, no window kernel launched). It accepts
multi-axis meshes by sharding the flat amplitude index over the axis
product, most significant qubits on the outer axis.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from rustqip_tpu_torch.engine.compile import PipelineEntry
from rustqip_tpu_torch.engine.fusion import DEFAULT_MAX_FUSED_QUBITS
from rustqip_tpu_torch.errors import CircuitError
from rustqip_tpu_torch.parallel.explicit import (  # noqa: F401  (gather_state: API)
    _ShardedCircuitBase,
    gather_state,
    mesh_key,
)
from rustqip_tpu_torch.parallel.shard_ops import _flat_geometry


class ShardedCircuit(_ShardedCircuitBase):
    """A CompiledCircuit whose state is sharded across a mesh of any shape,
    run with the kernel off."""

    def __init__(
        self,
        n: int,
        entries: Sequence[PipelineEntry],
        dtype,
        mesh,
        fuse: bool = True,
        max_fused_qubits: int = DEFAULT_MAX_FUSED_QUBITS,
        check_norm: bool = False,
    ):
        _, g = _flat_geometry(mesh)
        # Never the window kernel: the JAX package's GSPMD executor cannot
        # shard a ``pallas_call``, and fusion then keeps plain greedy joints
        # (the keep/joint exemptions only pay when kernel sweeps retire the
        # exempted ops).
        super().__init__(n, entries, dtype, mesh, g, fuse, max_fused_qubits,
                         check_norm, kernel_ok=False)


_CACHE: Dict[tuple, ShardedCircuit] = {}


def compile_sharded(
    n: int,
    entries: Sequence[PipelineEntry],
    dtype,
    mesh,
    fuse: bool = True,
    max_fused_qubits: int = DEFAULT_MAX_FUSED_QUBITS,
    check_norm: bool = False,
) -> ShardedCircuit:
    """Compile (with caching) a lowered pipeline for ``ShardedCircuit``."""
    dtype = np.dtype(dtype)
    fp = (
        n,
        dtype.str,
        fuse,
        max_fused_qubits,
        bool(check_norm),
        mesh_key(mesh),
        tuple(e.fingerprint() for e in entries),
    )
    cached = _CACHE.get(fp)
    if cached is None:
        cached = ShardedCircuit(
            n, entries, dtype, mesh, fuse, max_fused_qubits,
            check_norm=bool(check_norm),
        )
        _CACHE[fp] = cached
    return cached


def sharded_calculate_state(
    builder,
    it: Sequence[Tuple] = (),
    mesh=None,
    generator: Optional[torch.Generator] = None,
    seed: Optional[int] = None,
    strategy: str = "auto",
):
    """Sharded twin of ``LocalBuilder.calculate_state_with_init``: the same
    circuit, its state split over ``mesh`` (default: every CUDA device).

    ``strategy``: ``"explicit"`` (the hand-scheduled executor, which takes
    the window kernel on CUDA float32 shards; 1-D meshes), ``"gspmd"``
    (``ShardedCircuit``: the same schedule with the kernel off, any mesh
    shape), or ``"auto"`` (default): explicit on a 1-D mesh, gspmd
    otherwise. The builder's ``check_norm`` and, for the explicit
    executor, its ``kernel_ok`` carry over.

    Returns ``(re_shards, im_shards, Measurements)``, the state left on the
    shard devices (``gather_state`` fetches it to the host).
    """
    from rustqip_tpu_torch.builder.builder import Measurements, _lower_item
    from rustqip_tpu_torch.parallel.explicit import compile_sharded_explicit
    from rustqip_tpu_torch.parallel.mesh import make_shard_mesh
    from rustqip_tpu_torch.parallel.shard_ops import _mesh_geometry

    if mesh is None:
        mesh = make_shard_mesh()
    entries = []
    for item in builder.pipeline:
        entries.extend(_lower_item(item))
    if strategy == "auto":
        try:
            _mesh_geometry(mesh)
        except CircuitError:
            strategy = "gspmd"
        else:
            strategy = "explicit"
    if strategy == "explicit":
        cc = compile_sharded_explicit(
            builder.n, entries, builder.dtype, mesh,
            check_norm=builder._check_norm, kernel_ok=builder._kernel_ok,
        )
    elif strategy == "gspmd":
        cc = compile_sharded(builder.n, entries, builder.dtype, mesh,
                             check_norm=builder._check_norm)
    else:
        raise CircuitError(f"Unknown sharding strategy {strategy!r}")
    if generator is None:
        generator = torch.Generator()
        generator.manual_seed(
            seed if seed is not None else int(np.random.randint(0, 2**31 - 1))
        )
    re, im, results = cc.run(initial_index=builder.initial_index(it),
                             generator=generator)
    results_py = [
        (int(r[0]), float(r[1])) if isinstance(r, tuple) else r.cpu().numpy()
        for r in results
    ]
    return re, im, Measurements(results_py)
