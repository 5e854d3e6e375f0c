"""Port twin of ``examples/sharded_example.py``: the same circuit on a
sharded amplitude vector.

The state is split into 8 shards, as the original's 8-device mesh splits
it, but all on ``device``: the port holds a mesh's shards in one process
and a mesh may repeat a device, so one card runs it. The lines say how
many shards and how many distinct devices hold the state.

    python -m rustqip_tpu_torch.examples.sharded_example
"""

import numpy as np

from rustqip_tpu_torch.algos import qfft
from rustqip_tpu_torch.parallel import make_shard_mesh
from rustqip_tpu_torch.parallel.sharded import sharded_calculate_state
from rustqip_tpu_torch.prelude import LocalBuilder

SHARDS = 8


def build(b, n):
    r = b.register(n)
    qs = b.split_all_register(r)
    qs[0] = b.h(qs[0])                     # a distributed ("global") qubit
    qs[0], qs[-1] = b.cnot(qs[0], qs[-1])  # entangle across the seam
    r = qfft(b, b.merge_registers(qs))
    return b.measure_stochastic(r)


def main(device="cuda"):
    mesh = make_shard_mesh(SHARDS, devices=[device] * SHARDS)
    n = max(6, mesh.size.bit_length() + 3)
    print(f"devices: {len(set(mesh.devices))}, mesh: {mesh.size}, qubits: {n}")

    out = {"shards": mesh.size, "qubits": n}
    for strategy in ("gspmd", "explicit"):
        b = LocalBuilder(dtype="f32", device=device)
        _, handle = build(b, n)
        re, im, measured = sharded_calculate_state(
            b, mesh=mesh, seed=0, strategy=strategy
        )
        probs = measured.get_stochastic_measurement(handle)
        norm, top = float(np.sum(probs)), float(probs.max())
        print(
            f"{strategy:>8}: state split into {len(re)} shard(s) on "
            f"{len({t.device for t in re})} device(s); "
            f"norm = {norm:.6f}; "
            f"top outcome p = {top:.4f}"
        )
        out[strategy] = {"norm": norm, "top_p": top}
    return out


if __name__ == "__main__":
    main()
