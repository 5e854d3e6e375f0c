"""Free-function gate ops usable as program lines.

Port of ``rustqip_tpu/dsl/ops.py``.

Mirrors ``qip/src/macros/program_ops.rs``: plain ``fn(builder, registers...)
-> registers`` wrappers around the builder gate methods, so they slot
directly into ``p.apply(...)`` lines.
"""

from __future__ import annotations


def not_(b, r):
    return b.not_(r)


# The reference exports `not`; Python can't, so both spellings are offered.
def x(b, r):
    return b.x(r)


def y(b, r):
    return b.y(r)


def z(b, r):
    return b.z(r)


def h(b, r):
    return b.h(r)


def s(b, r):
    return b.s(r)


def t(b, r):
    return b.t(r)


def cnot(b, cr, r):
    return b.cnot(cr, r)


def toffoli(b, cr, r):
    return b.toffoli(cr, r)


def swap(b, ra, rb):
    return b.swap(ra, rb)


def rz(b, theta, r):
    return b.rz(r, theta)
