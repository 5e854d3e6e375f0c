"""Circuit inversion via shadow builders (port of
``rustqip_tpu/builder/inverter.py``; host-only).

Mirrors ``qip/src/inverter.rs``: to invert the circuit a function would
build, record it in a fresh shadow builder, export the pipeline, reverse +
invert each object, and replay onto the real registers.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

from rustqip_tpu_torch.builder.registers import Register
from rustqip_tpu_torch.errors import CircuitError


def inverter_args(
    cb,
    rs: Sequence[Register],
    f: Callable,
    *args,
    **kwargs,
) -> List[Register]:
    """Apply the inverse of the circuit ``f`` builds to registers ``rs``
    (ref ``inverter_args``, inverter.rs:48-82).

    ``f(shadow_builder, *shadow_registers, *args, **kwargs)`` must return
    the registers (in order); non-register arguments pass through.
    """
    sub_cb = cb.new_similar()
    sub_rs = [sub_cb.register(r.n) for r in rs]
    f(sub_cb, *sub_rs, *args, **kwargs)
    subcircuit = sub_cb.make_subcircuit()

    ranges = []
    offset = 0
    for r in rs:
        ranges.append(range(offset, offset + r.n))
        offset += r.n

    merged = cb.merge_registers(rs)
    if merged is None:
        raise CircuitError("inverter needs at least one register")
    merged = cb.apply_inverted_subcircuit(subcircuit, merged)
    res = cb.split_relative_index_groups(merged, ranges)
    if res.remaining is not None:  # pragma: no cover
        raise CircuitError("inverter split mismatch")
    return res.selected


def inverter(cb, rs: Sequence[Register], f: Callable) -> List[Register]:
    """No-extra-args variant (ref inverter.rs:86-95)."""
    return inverter_args(cb, rs, f)
