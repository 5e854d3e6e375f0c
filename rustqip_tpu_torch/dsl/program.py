"""The ``program`` DSL helpers the main path needs.

Port of ``negate_bitmask`` from ``rustqip_tpu/dsl/program.py``:29; the
``program`` context manager and the rest of ``dsl/`` wait for a later
slice (ROADMAP port queue).
"""

from __future__ import annotations

from rustqip_tpu_torch.builder.registers import Register


def negate_bitmask(b, r: Register, mask: int) -> Register:
    """X every qubit of ``r`` whose mask bit is 0 — the ``control(0b110)``
    helper (ref qip/src/macros/program.rs:6-22). Mask bit i corresponds to
    the register's i-th qubit."""
    qs = b.split_all_register(r)
    out = []
    for i, q in enumerate(qs):
        if not (mask >> i) & 1:
            q = b.not_(q)
        out.append(q)
    return b.merge_registers(out)
