"""Sharded state vectors: the amplitudes split over a mesh of devices.

Port of ``rustqip_tpu/parallel``. The 2^n amplitudes shard along the top
(most significant) qubits over a ``ShardMesh``; gates on local qubits run
shard-local (the window kernel on CUDA float32 shards), gates on sharded
qubits read partner shards, and measurement reductions sum over the
shards. One process drives every shard, as one controller drives the JAX
package's mesh; a mesh may repeat a device (``make_shard_mesh(8,
devices=["cuda:0"] * 8)``).
"""

from rustqip_tpu_torch.parallel.mesh import make_multislice_mesh, make_shard_mesh
from rustqip_tpu_torch.parallel.sharded import (
    ShardedCircuit,
    compile_sharded,
    sharded_calculate_state,
)
from rustqip_tpu_torch.parallel.explicit import (
    ExplicitShardedCircuit,
    compile_sharded_explicit,
)

__all__ = [
    "make_shard_mesh",
    "make_multislice_mesh",
    "ShardedCircuit",
    "compile_sharded",
    "sharded_calculate_state",
    "ExplicitShardedCircuit",
    "compile_sharded_explicit",
]
