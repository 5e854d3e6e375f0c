"""The ``program`` DSL: textbook-notation lines over register slices.

Port of ``rustqip_tpu/dsl/program.py`` (host-only, line for line).

Re-design of the ``program!`` proc-macro (qip-macros/src/lib.rs:93-354).
The macro's expansion — split every input register into per-qubit slots,
per line take the selected qubits, merge into per-group registers, call the
function (optionally under a control), re-split results back into slots,
finally re-merge — is implemented here as a context manager with selector
proxies:

    with program(b, ra=ra, rb=rb) as p:
        p.apply(gamma, p.ra[0:2], p.ra[2])            # gamma ra[0..2], ra[2]
        p.apply(gamma, (p.ra[0], p.rb[0]), p.ra[2])   # gamma [ra[0],rb[0]], ra[2]
        p.control(p.rb).apply(gamma, p.ra[0:2], p.ra[2])        # control gamma
        p.control(p.rb, mask=0b110).apply(gamma, p.ra[0:2], p.ra[2])
    ra, rb = p.results()

Non-register arguments precede the selectors, as in the reference:
``p.apply(gamma, True, p.ra[0:2], p.ra[2])`` is ``gamma(true) ra[0..2], ra[2]``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

from rustqip_tpu_torch.builder.registers import Register
from rustqip_tpu_torch.errors import CircuitError


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


class Selector:
    """A reference to specific qubits of a named program register."""

    __slots__ = ("name", "positions")

    def __init__(self, name: str, positions: Tuple[int, ...]):
        self.name = name
        self.positions = positions

    def __repr__(self):
        return f"{self.name}[{list(self.positions)}]"


class RegProxy:
    """``p.ra`` — selects the whole register; index/slice for parts."""

    __slots__ = ("_name", "_size")

    def __init__(self, name: str, size: int):
        self._name = name
        self._size = size

    def __getitem__(self, key) -> Selector:
        if isinstance(key, slice):
            positions = tuple(range(*key.indices(self._size)))
        elif isinstance(key, int):
            if not 0 <= key < self._size:
                raise CircuitError(
                    f"Index {key} out of range for register "
                    f"{self._name} of size {self._size}"
                )
            positions = (key,)
        else:
            positions = tuple(int(k) for k in key)
        if not positions:
            raise CircuitError(f"Empty selection on register {self._name}")
        return Selector(self._name, positions)

    def _whole(self) -> Selector:
        return Selector(self._name, tuple(range(self._size)))


SelectorLike = Union[Selector, RegProxy, Tuple, List]


class _ControlledLine:
    def __init__(self, prog: "Program", control: SelectorLike, mask: Optional[int]):
        self._prog = prog
        self._control = control
        self._mask = mask

    def apply(self, fn, *args):
        return self._prog._apply_line(fn, args, self._control, self._mask)

    # alias
    call = apply


class Program:
    """Live state of one ``program`` block: per-qubit register slots."""

    def __init__(self, builder, regs: Dict[str, Register]):
        if not regs:
            raise CircuitError("program() needs at least one register")
        names = list(regs.keys())
        if len(set(names)) != len(names):  # pragma: no cover (kwargs unique)
            raise CircuitError("Duplicate register names")
        self._b = builder
        self._names = names
        self._sizes = {k: r.n for k, r in regs.items()}
        # Split every register into per-qubit slots (macro expansion
        # lib.rs:134-136).
        self._slots: Dict[str, List[Optional[Register]]] = {
            k: list(builder.split_all_register(r)) for k, r in regs.items()
        }
        self._finished = False
        self._outputs: Optional[List[Register]] = None

    # -- proxies ------------------------------------------------------------
    def __getattr__(self, name: str):
        sizes = object.__getattribute__(self, "_sizes")
        if name in sizes:
            return RegProxy(name, sizes[name])
        raise AttributeError(name)

    def __getitem__(self, name: str) -> RegProxy:
        return RegProxy(name, self._sizes[name])

    # -- lines ----------------------------------------------------------------
    def control(self, control: SelectorLike, mask: Optional[int] = None):
        """Next ``.apply`` runs conditioned on ``control`` (all-ones, or the
        given mask pattern — macro's ``control``/``control(mask)`` prefix,
        lib.rs:146-211)."""
        return _ControlledLine(self, control, mask)

    def apply(self, fn, *args):
        """One program line: ``fn`` applied to the selected register groups.
        Leading non-selector arguments pass through (lib.rs:152-159)."""
        return self._apply_line(fn, args, None, None)

    call = apply

    # -- mechanics -------------------------------------------------------------
    def _normalize(self, arg) -> Optional[List[Selector]]:
        """A selector-group as a flat list of Selectors, or None if ``arg``
        is a plain (non-register) value."""
        if isinstance(arg, Selector):
            return [arg]
        if isinstance(arg, RegProxy):
            return [arg._whole()]
        if isinstance(arg, (tuple, list)) and arg and all(
            isinstance(a, (Selector, RegProxy)) for a in arg
        ):
            return [
                a._whole() if isinstance(a, RegProxy) else a for a in arg
            ]
        if isinstance(arg, Register):
            raise CircuitError(
                "Pass raw registers to program() up front; use p.<name> "
                "selectors inside the block"
            )
        return None

    def _take(self, selectors: List[Selector], taken: List[Tuple[str, int]]):
        qubits = []
        for sel in selectors:
            for pos in sel.positions:
                slot = self._slots[sel.name][pos]
                if slot is None:
                    raise CircuitError(
                        f"Qubit {sel.name}[{pos}] used twice in one line"
                    )
                qubits.append(slot)
                self._slots[sel.name][pos] = None
                taken.append((sel.name, pos))
        return self._b.merge_registers(qubits)

    def _apply_line(self, fn, args, control: Optional[SelectorLike], mask):
        if self._finished:
            raise CircuitError("program block already finished")
        # Partition args: leading plain values, then selector groups.
        plain: List = []
        groups: List[List[Selector]] = []
        for arg in args:
            norm = self._normalize(arg)
            if norm is None:
                if groups:
                    raise CircuitError(
                        "Non-register arguments must precede register "
                        "selectors (as in the reference program! macro)"
                    )
                plain.append(arg)
            else:
                groups.append(norm)
        if not groups:
            raise CircuitError("Program line selects no registers")

        taken: List[Tuple[str, int]] = []
        regs = [self._take(g, taken) for g in groups]

        builder = self._b
        ctrl_reg = None
        if control is not None:
            ctrl_sel = self._normalize(control)
            ctrl_taken: List[Tuple[str, int]] = []
            ctrl_reg = self._take(ctrl_sel, ctrl_taken)
            if mask is not None:
                ctrl_reg = negate_bitmask(builder, ctrl_reg, mask)
            builder = self._b.condition_with(ctrl_reg)

        result = fn(builder, *plain, *regs)

        if control is not None:
            ctrl_reg = builder.dissolve()
            if mask is not None:
                ctrl_reg = negate_bitmask(self._b, ctrl_reg, mask)
            # Return control qubits to their slots.
            ctrl_qubits = self._b.split_all_register(ctrl_reg)
            for (name, pos), q in zip(ctrl_taken, ctrl_qubits):
                self._slots[name][pos] = q

        # Re-split results back into the taken slots by position
        # (macro expansion lib.rs:299-319).
        if result is None:
            raise CircuitError(
                f"Program line function {getattr(fn, '__name__', fn)!r} "
                "returned no registers"
            )
        if isinstance(result, Register):
            result = (result,)
        out_qubits: List[Register] = []
        for reg in result:
            out_qubits.extend(self._b.split_all_register(reg))
        if len(out_qubits) != len(taken):
            raise CircuitError(
                f"Program line returned {len(out_qubits)} qubits, "
                f"expected {len(taken)}"
            )
        for (name, pos), q in zip(taken, out_qubits):
            self._slots[name][pos] = q
        return None

    # -- finalize ---------------------------------------------------------------
    def _finish(self):
        if not self._finished:
            self._finished = True
            outs = []
            for name in self._names:
                slots = self._slots[name]
                if any(s is None for s in slots):  # pragma: no cover
                    raise CircuitError(f"Register {name} has missing qubits")
                outs.append(self._b.merge_registers(slots))
            self._outputs = outs

    def results(self) -> Tuple[Register, ...]:
        self._finish()
        return tuple(self._outputs)

    def __enter__(self) -> "Program":
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self._finish()
        return False

    def __iter__(self):
        return iter(self.results())


def program(builder, **regs: Register) -> Program:
    """Open a program block over named registers (the ``program!`` analog).

    Usage::

        with program(b, ra=ra, rb=rb) as p:
            p.apply(gamma, p.ra[0:2], p.ra[2])
        ra, rb = p.results()
    """
    return Program(builder, regs)
