"""Shard meshes: the devices that hold the shards of one state vector.

Port of ``rustqip_tpu/parallel/mesh.py``. The JAX package shards over a
``jax.sharding.Mesh``; the port has no device mesh of its own, so
``ShardMesh`` is a small frozen record of the shard devices in shard order,
the mesh's shape and its axis names. One process drives every shard (the
JAX package is single-controller too). A device may repeat: eight shards
of one state on ``cuda:0``, or on ``"cpu"`` in the tests, are the
counterpart of the JAX package's eight virtual XLA CPU devices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from rustqip_tpu_torch.errors import CircuitError


@dataclass(frozen=True)
class ShardMesh:
    """Shard devices in shard order (row-major over ``shape``: the outer
    axis holds the most significant shard bits)."""

    devices: Tuple[torch.device, ...]
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def _cuda_devices() -> list:
    """Every CUDA device; raises when there is none (no CPU fallback)."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise CircuitError(
            "no CUDA device: pass devices= (e.g. ['cpu'] * 8) for a mesh "
            "off the card"
        )
    return [torch.device("cuda", i) for i in range(count)]


def _as_devices(devices: Sequence) -> list:
    return [torch.device(d) for d in devices]


def make_shard_mesh(
    n_devices: Optional[int] = None,
    axis: str = "shard",
    devices: Optional[Sequence] = None,
) -> ShardMesh:
    """A 1-D mesh for amplitude sharding.

    The amplitude index's top ``log2(n_devices)`` bits select the shard, so
    neighboring shards hold contiguous pieces of the state. ``devices``
    defaults to every CUDA device; an explicit list may repeat a device.
    """
    devices = _cuda_devices() if devices is None else _as_devices(devices)
    if n_devices is None:
        # Largest power of two available.
        n_devices = 1 << (len(devices).bit_length() - 1)
    if n_devices < 1 or n_devices & (n_devices - 1):
        raise CircuitError(
            f"Amplitude sharding needs a power-of-two device count, got "
            f"{n_devices}"
        )
    if n_devices > len(devices):
        raise CircuitError(
            f"Requested {n_devices} devices but only {len(devices)} available"
        )
    return ShardMesh(tuple(devices[:n_devices]), (n_devices,), (axis,))


def make_multislice_mesh(
    n_slices: int,
    per_slice: Optional[int] = None,
    devices: Optional[Sequence] = None,
    axes: Tuple[str, str] = ("dcn", "shard"),
) -> ShardMesh:
    """A 2-D (slice x shard) mesh.

    The amplitude index shards over the axis product with the most
    significant qubits on the outer axis: gates on those qubits are the
    rarest exchanges, so the slowest links carry the least traffic. Runs
    through ``compile_sharded`` (the explicit executor is 1-D).
    """
    devices = _cuda_devices() if devices is None else _as_devices(devices)
    if per_slice is None:
        per_slice = len(devices) // n_slices
    total = n_slices * per_slice
    for dim, name in ((n_slices, "n_slices"), (per_slice, "per_slice")):
        if dim < 1 or dim & (dim - 1):
            raise CircuitError(
                f"Amplitude sharding needs power-of-two mesh dims; "
                f"{name}={dim}"
            )
    if total > len(devices):
        raise CircuitError(
            f"Requested {total} devices but only {len(devices)} available"
        )
    return ShardMesh(tuple(devices[:total]), (n_slices, per_slice), tuple(axes))
