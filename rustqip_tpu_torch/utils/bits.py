"""Bit-manipulation utilities shared across the framework.

Covers the reference's two util modules:
* ``qip-iterators/src/utils.rs`` — ``get_flat_index``, ``flip_bits``,
  ``set_bit``, ``get_bit``.
* ``qip/src/utils.rs`` — ``entwine_bits``, ``extract_bits``,
  ``transpose_sparse``.

These operate on Python ints (circuit-construction time, never traced), so
they are plain Python. Device-side index math lives in the engine.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, TypeVar

T = TypeVar("T")


def get_flat_index(nindices: int, i: int, j: int) -> int:
    """Row-major index into a 2^nindices square op matrix
    (``qip-iterators/src/utils.rs:5``)."""
    return (i << nindices) + j


def flip_bits(n: int, num: int) -> int:
    """Reverse the low ``n`` bits of ``num`` (``qip-iterators/src/utils.rs:22``).

    >>> flip_bits(3, 0b100)
    1
    >>> flip_bits(4, 0b1010)
    5
    """
    out = 0
    for i in range(n):
        out |= ((num >> i) & 1) << (n - 1 - i)
    return out


def set_bit(num: int, bit_index: int, value: bool) -> int:
    """Set bit ``bit_index`` of ``num`` (``qip-iterators/src/utils.rs:37``)."""
    v = 1 << bit_index
    return (num | v) if value else (num & ~v)


def get_bit(num: int, bit_index: int) -> bool:
    """Get bit ``bit_index`` of ``num`` (``qip-iterators/src/utils.rs:55``)."""
    return ((num >> bit_index) & 1) != 0


def extract_bits(num: int, indices: Sequence[int]) -> int:
    """Gather bits of ``num`` at positions ``indices``; result bit ``i`` is
    ``num``'s bit ``indices[i]`` (``qip/src/utils.rs:55``).

    >>> extract_bits(0b1010, [3, 0])
    1
    """
    acc = 0
    for i, index in enumerate(indices):
        acc |= ((num >> index) & 1) << i
    return acc


def entwine_bits(n: int, selector: int, off_bits: int, on_bits: int) -> int:
    """Interleave two bitstreams under a selector mask
    (``qip/src/utils.rs:21``): output bit ``i`` takes the next-lowest bit of
    ``on_bits`` when selector bit ``i`` is 1, else of ``off_bits``.

    >>> entwine_bits(3, 0b010, 0b01, 0b1)
    3
    """
    result = 0
    for i in range(n):
        if (selector >> i) & 1 == 0:
            result |= (off_bits & 1) << i
            off_bits >>= 1
        else:
            result |= (on_bits & 1) << i
            on_bits >>= 1
    return result


def transpose_sparse(
    sparse_mat: Sequence[Sequence[Tuple[int, T]]],
) -> List[List[Tuple[int, T]]]:
    """Transpose a row-major sparse matrix stored as per-row ``(col, val)``
    lists (``qip/src/utils.rs:63``). Output rows are sorted by column-of-origin
    to match the reference's ``sort_by_key(row)``.
    """
    out: List[List[Tuple[int, T]]] = [[] for _ in range(len(sparse_mat))]
    for row, entries in enumerate(sparse_mat):
        for col, val in entries:
            out[col].append((row, val))
    for entries in out:
        entries.sort(key=lambda rv: rv[0])
    return out


def full_to_sub(n: int, mat_indices: Sequence[int], full_index: int) -> int:
    """Project a full 2^n state index onto an op's sub-space index
    (``qip-iterators/src/matrix_ops.rs:12``).

    Big-endian convention: qubit ``q`` is bit ``n-1-q`` of the full index; the
    op's j-th qubit is bit ``k-1-j`` of the sub index.
    """
    nindices = len(mat_indices)
    acc = 0
    for j, indx in enumerate(mat_indices):
        bit = (full_index >> (n - 1 - indx)) & 1
        acc = set_bit(acc, nindices - 1 - j, bool(bit))
    return acc


def sub_to_full(n: int, mat_indices: Sequence[int], sub_index: int, base: int) -> int:
    """Scatter an op sub-space index back into a full state index over
    ``base`` (``qip-iterators/src/matrix_ops.rs:24``)."""
    nindices = len(mat_indices)
    acc = base
    for j, indx in enumerate(mat_indices):
        bit = (sub_index >> (nindices - 1 - j)) & 1
        acc = set_bit(acc, n - 1 - indx, bool(bit))
    return acc
