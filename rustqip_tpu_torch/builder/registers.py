"""Linear-typed qubit registers.

The reference leans on Rust move semantics: every gate call consumes its
register handles and returns fresh ones, so a qubit can never be used twice
concurrently — the borrow checker enforcing the no-cloning theorem
(``qip/src/lib.rs:16-17``, ``qip/src/builder.rs:66-99``). Python has no
moves, so ``Register`` carries a liveness flag: builder operations consume
handles (marking them dead) and hand back fresh live ones; reusing a dead
handle raises immediately with a pointer at the earlier consumption site.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from rustqip_tpu_torch.errors import CircuitError


class Register:
    """A handle to an ordered set of absolute qubit indices.

    Equivalent of the reference's ``Qudit`` (builder.rs:66-78): merging and
    splitting registers is index-list manipulation only; nothing numeric
    happens until ``calculate_state*``.
    """

    __slots__ = ("indices", "_live", "_consumed_by")

    def __init__(self, indices: Sequence[int]):
        indices = tuple(int(i) for i in indices)
        if not indices:
            raise CircuitError("Registers must contain at least one qubit")
        self.indices = indices
        self._live = True
        self._consumed_by: Optional[str] = None

    @property
    def n(self) -> int:
        return len(self.indices)

    def __len__(self) -> int:
        return self.n

    def __repr__(self) -> str:
        status = "" if self._live else f" (consumed by {self._consumed_by})"
        return f"Register{list(self.indices)}{status}"


def consume(r: Register, by: str = "operation") -> Tuple[int, ...]:
    """Consume a register handle, enforcing linearity (no-cloning)."""
    if not isinstance(r, Register):
        raise CircuitError(f"Expected a Register, got {type(r).__name__}")
    if not r._live:
        raise CircuitError(
            f"Register {list(r.indices)} was already consumed by "
            f"{r._consumed_by}; registers are linear — use the handle "
            "returned by the previous operation (no-cloning)."
        )
    r._live = False
    r._consumed_by = by
    return r.indices


class SplitResult:
    """Result of splitting a register in two
    (ref ``SplitResult``, builder_traits.rs:23-30).

    ``selected`` holds the chosen qubits, ``remaining`` the rest; either may
    be None when the split was all-or-nothing.
    """

    __slots__ = ("selected", "remaining")

    def __init__(self, selected: Optional[Register], remaining: Optional[Register]):
        self.selected = selected
        self.remaining = remaining

    @property
    def kind(self) -> str:
        if self.selected is not None and self.remaining is not None:
            return "SPLIT"
        return "SELECTED" if self.selected is not None else "UNSELECTED"

    def __iter__(self):
        return iter((self.selected, self.remaining))

    def __repr__(self) -> str:
        return f"SplitResult({self.kind}: {self.selected}, {self.remaining})"


class SplitManyResult:
    """Result of splitting into index groups
    (ref ``SplitManyResult``, builder_traits.rs:34-57)."""

    __slots__ = ("selected", "remaining")

    def __init__(self, selected: List[Register], remaining: Optional[Register]):
        self.selected = selected
        self.remaining = remaining

    @property
    def all_selected(self) -> bool:
        return self.remaining is None

    def get_selected(self) -> List[Register]:
        return self.selected

    def __iter__(self):
        return iter((self.selected, self.remaining))
