"""Circuit errors.

Mirrors the reference error surface (``qip/src/errors.rs:6-32``): a single
generic error type carrying a message. Python exceptions replace Rust's
``Result``: functions that return ``CircuitResult<T>`` in the reference raise
``CircuitError`` here instead.
"""

from __future__ import annotations


class CircuitError(Exception):
    """Generic circuit-construction or execution error.

    Equivalent of the reference's ``CircuitError::Generic(String)``
    (``qip/src/errors.rs:6``).
    """

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"CircuitError({self.message!r})"
