"""The ``@invertible`` decorator: automatic circuit inverses.

Port of ``rustqip_tpu/dsl/invert.py`` (host-only, line for line).

Re-design of the ``#[invert]`` attribute macro (qip-macros/src/lib.rs:
371-531): decorating a circuit function attaches ``fn.inv``, which records
``fn`` in a fresh shadow builder, inverts the exported pipeline, and replays
it onto the real registers. Non-register arguments pass through positionally
(the macro requires listing them; here they're detected at call time).
"""

from __future__ import annotations

import functools
from typing import Callable, List

from rustqip_tpu_torch.builder.registers import Register
from rustqip_tpu_torch.errors import CircuitError


def _make_inverse(fn: Callable, inv_name: str) -> Callable:
    @functools.wraps(fn)
    def inv(b, *args, **kwargs):
        # Positions of register arguments (the macro's register params).
        reg_positions = [i for i, a in enumerate(args) if isinstance(a, Register)]
        if not reg_positions:
            raise CircuitError(f"{inv_name} needs at least one register argument")
        regs: List[Register] = [args[i] for i in reg_positions]

        # Trace fn into a shadow builder (lib.rs:512-527).
        shadow = b.new_similar()
        shadow_args = list(args)
        for i in reg_positions:
            shadow_args[i] = shadow.register(args[i].n)
        fn(shadow, *shadow_args, **kwargs)
        subcircuit = shadow.make_subcircuit()

        # Replay inverted onto the real merged registers.
        sizes = [r.n for r in regs]
        merged = b.merge_registers(regs)
        merged = b.apply_inverted_subcircuit(subcircuit, merged)
        ranges, offset = [], 0
        for sz in sizes:
            ranges.append(range(offset, offset + sz))
            offset += sz
        res = b.split_relative_index_groups(merged, ranges)
        if res.remaining is not None:  # pragma: no cover
            raise CircuitError("invertible split mismatch")
        out = res.selected
        return out[0] if len(out) == 1 else tuple(out)

    inv.__name__ = inv_name
    inv.__qualname__ = inv_name
    return inv


def invertible(fn: Callable = None, *, name: str = None):
    """Attach ``fn.inv`` (optionally named, like ``#[invert(gamma_inv)]``).

    Usage::

        @invertible
        def gamma(b, ra, rb): ...
        gamma.inv(b, ra, rb)   # applies gamma^-1
    """

    def wrap(f: Callable):
        inv_name = name or f"{f.__name__}_inv"
        f.inv = _make_inverse(f, inv_name)
        return f

    if fn is not None:
        return wrap(fn)
    return wrap
