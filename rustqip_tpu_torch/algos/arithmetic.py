"""Reversible arithmetic circuits (Rieffel & Polak ch. 6.4 constructions).

Port of ``rustqip_tpu/algos/arithmetic.py`` (host-only, line for line).

Re-design of ``qip/src/boolean_circuits/arithmetic.rs`` on the ``program``/
``invertible`` DSL. Register value convention throughout: bit j of a value
lives on the register's j-th qubit (little-endian across the register, the
same convention as circuit init values and measurement outcomes).

Circuits (reference line refs):
* ``add``       — ripple adder, rb += ra with carry scratch rc (:30-59)
* ``sum_``/``carry`` — adder primitives (:61-89)
* ``add_mod``   — rb = (ra + rb) mod rm (:94-132)
* ``times_mod`` — rp = (rp + rb*ra) mod rm (:137-193)
* ``rshift``/``lshift`` — qubit rotation (:197-218)
* ``copy``      — |a>|b> -> |a>|a^b> (:222-250)
* ``square_mod``— rs = (rs + ra^2) mod rm (:254-284)
* ``exp_mod``   — re = (rp * ra^rb) mod rm (:288-340), the Shor-style
  square-and-multiply modular exponentiation

All are ``@invertible`` — the uncompute passes in ``times_mod``/``exp_mod``
use the generated inverses, as in the reference.
"""

from __future__ import annotations

from rustqip_tpu_torch.dsl import invertible, ops, program
from rustqip_tpu_torch.errors import CircuitError


def sum_(b, rc, ra, rb):
    """rb ^= ra ^ rc — the adder's sum bit (ref :61-71)."""
    with program(b, rc=rc, ra=ra, rb=rb) as p:
        p.control(p.ra).apply(ops.x, p.rb)
        p.control(p.rc).apply(ops.x, p.rb)
    return p.results()


@invertible
def carry(b, rc, ra, rb, rcp):
    """rcp ^= majority-carry of (rc, ra, rb) (ref :73-89)."""
    with program(b, rc=rc, ra=ra, rb=rb, rcp=rcp) as p:
        p.control((p.ra, p.rb)).apply(ops.x, p.rcp)
        p.control(p.ra).apply(ops.x, p.rb)
        p.control((p.rc, p.rb)).apply(ops.x, p.rcp)
        p.control(p.ra).apply(ops.x, p.rb)
    return p.results()


@invertible
def add(b, rc, ra, rb):
    """Ripple adder: rb += ra using carry scratch rc (ref :30-59).

    rc and ra have m qubits, rb has m+1; requires the high qubit of rb and
    all of rc to start |0>.
    """
    nc, na, nb = rc.n, ra.n, rb.n
    if (nc, na, nb) == (1, 1, 2):
        with program(b, rc=rc, ra=ra, rb=rb) as p:
            p.apply(carry, p.rc, p.ra, p.rb[0], p.rb[1])
            p.apply(sum_, p.rc, p.ra, p.rb[0])
        return p.results()
    if nc == na and nc + 1 == nb:
        n = nc
        with program(b, rc=rc, ra=ra, rb=rb) as p:
            p.apply(carry, p.rc[0], p.ra[0], p.rb[0], p.rc[1])
            p.apply(add, p.rc[1:n], p.ra[1:n], p.rb[1 : n + 1])
            p.apply(carry.inv, p.rc[0], p.ra[0], p.rb[0], p.rc[1])
            p.apply(sum_, p.rc[0], p.ra[0], p.rb[0])
        return p.results()
    raise CircuitError(
        f"Expected rc[n] ra[n] and rb[n+1], but got ({nc},{na},{nb})"
    )


@invertible
def add_mod(b, ra, rb, rm):
    """rb = (ra + rb) mod rm, for a,b < M, M > 0 (ref :94-132).

    ra and rm have n qubits, rb has n+1.
    """
    if ra.n != rm.n:
        raise CircuitError(
            f"Expected rm.n == ra.n == {ra.n}, found rm.n={rm.n}."
        )
    if rb.n != ra.n + 1:
        raise CircuitError(
            f"Expected rb.n == ra.n + 1 == {ra.n + 1}, found rb.n={rb.n}."
        )
    n = ra.n
    rt = b.make_zeroed_temp_qubit()
    rc = b.make_zeroed_temp_register(n)
    with program(b, ra=ra, rb=rb, rm=rm, rt=rt, rc=rc) as p:
        p.apply(add, p.rc, p.ra, p.rb)
        p.apply(add.inv, p.rc, p.rm, p.rb)
        p.control(p.rb[n]).apply(ops.x, p.rt)
        p.control(p.rt).apply(add, p.rc, p.rm, p.rb)
        p.apply(add.inv, p.rc, p.ra, p.rb)
        p.control(p.rb[n], mask=0).apply(ops.x, p.rt)
        p.apply(add, p.rc, p.ra, p.rb)
    ra, rb, rm, rt, rc = p.results()
    b.return_zeroed_temp_register(rt)
    b.return_zeroed_temp_register(rc)
    return ra, rb, rm


@invertible
def times_mod(b, ra, rb, rm, rp):
    """|a>|b>|M>|p>  ->  |a>|b>|M>|(p + b*a) mod M> (ref :137-193).

    a[n+1], b[k], M[n], p[n+1], with a,p < M, M > 0.
    """
    n = rm.n
    k = rb.n
    if ra.n != n + 1:
        raise CircuitError(
            f"Expected ra.n = rm.n + 1 = {n + 1}, but found {ra.n}"
        )
    if rp.n != n + 1:
        raise CircuitError(
            f"Expected rp.n = rm.n + 1 = {n + 1}, but found {rp.n}"
        )
    rt = b.make_zeroed_temp_register(k)
    rc = b.make_zeroed_temp_register(n)

    regs = (ra, rb, rm, rp, rt, rc)
    for indx in range(k):
        ra, rb, rm, rp, rt, rc = regs
        with program(b, ra=ra, rb=rb, rm=rm, rp=rp, rt=rt, rc=rc) as p:
            p.apply(add.inv, p.rc, p.rm, p.ra)
            p.control(p.ra[n]).apply(ops.x, p.rt[indx])
            p.control(p.rt[indx]).apply(add, p.rc, p.rm, p.ra)
            p.control(p.rb[indx]).apply(add_mod, p.ra[0:n], p.rp, p.rm)
            p.apply(rshift, p.ra)
        regs = p.results()
    for indx in reversed(range(k)):
        ra, rb, rm, rp, rt, rc = regs
        with program(b, ra=ra, rm=rm, rt=rt, rc=rc) as p:
            p.apply(lshift, p.ra)
            p.control(p.rt[indx]).apply(add.inv, p.rc, p.rm, p.ra)
            p.control(p.ra[n]).apply(ops.x, p.rt[indx])
            p.apply(add, p.rc, p.rm, p.ra)
        ra, rm, rt, rc = p.results()
        regs = (ra, rb, rm, rp, rt, rc)
    ra, rb, rm, rp, rt, rc = regs
    b.return_zeroed_temp_register(rc)
    b.return_zeroed_temp_register(rt)
    return ra, rb, rm, rp


@invertible(name="lshift")
def rshift(b, r):
    """Rotate qubit values down the register (ref :197-218): after rshift,
    value bit j moves to bit j+1 (mod n) — i.e. doubles the register value
    modulo wraparound."""
    n = r.n
    rs = list(b.split_all_register(r))
    for indx in reversed(range(n - 1)):
        offset = (indx - 1) % n
        ra, rb_ = b.swap(rs[indx], rs[offset])
        rs[indx], rs[offset] = ra, rb_
    return b.merge_registers(rs)


lshift = rshift.inv


@invertible
def copy(b, ra, rb):
    """|a>|b> -> |a>|a ^ b>; a copy for b=0 (ref :222-250)."""
    if ra.n != rb.n:
        raise CircuitError(
            f"Expected ra.n = rb.n, but found {ra.n} and {rb.n}"
        )
    ras = b.split_all_register(ra)
    rbs = b.split_all_register(rb)
    out_a, out_b = [], []
    for qa, qb in zip(ras, rbs):
        qa, qb = b.cnot(qa, qb)
        out_a.append(qa)
        out_b.append(qb)
    return b.merge_registers(out_a), b.merge_registers(out_b)


@invertible
def square_mod(b, ra, rm, rs):
    """|a>|M>|s> -> |a>|M>|(s + a*a) mod M> (ref :254-284)."""
    n = rm.n
    if ra.n != n + 1:
        raise CircuitError(
            f"Expected ra.n = rm.n + 1 = {n + 1}, but found {ra.n}"
        )
    if rs.n != n + 1:
        raise CircuitError(
            f"Expected rs.n = rm.n + 1 = {n + 1}, but found {rs.n}"
        )
    rt = b.make_zeroed_temp_register(n)
    with program(b, ra=ra, rm=rm, rs=rs, rt=rt) as p:
        p.apply(copy, p.ra[0:n], p.rt)
        p.apply(times_mod, p.ra, p.rt, p.rm, p.rs)
        p.apply(copy.inv, p.ra[0:n], p.rt)
    ra, rm, rs, rt = p.results()
    b.return_zeroed_temp_register(rt)
    return ra, rm, rs


@invertible
def exp_mod(b, ra, rb, rm, rp, re):
    """|a>|b>|M>|p>|0> -> |a>|b>|M>|p>|(p * a^b) mod M> (ref :288-340).

    Recursive square-and-multiply — the Shor-style modular exponentiation.
    a[n+1], b[k], M[n], p[n+1], e[n+1].

    Note: the recursion's controlled times_mod lines target the scratch
    ``rv`` (v = p*a when b0=1), then recurse e = v * (a^2)^(b>>1). The
    reference targets ``re`` there (arithmetic.rs:327,331), which the
    uncompute pass cancels for odd exponents — its truth-table tests are
    disabled upstream; ours (tests/test_torch_arithmetic.py) pin the correct
    semantics.
    """
    n = rm.n
    k = rb.n
    for reg, nm in ((ra, "ra"), (rp, "rp"), (re, "re")):
        if reg.n != n + 1:
            raise CircuitError(
                f"Expected {nm}.n = rm.n + 1 = {n + 1}, but found {reg.n}"
            )
    if k == 1:
        with program(b, ra=ra, rb=rb, rm=rm, rp=rp, re=re) as p:
            p.control(p.rb[0], mask=0).apply(copy, p.rp, p.re)
            p.control(p.rb[0]).apply(times_mod, p.ra, p.rp, p.rm, p.re)
        return p.results()
    ru = b.make_zeroed_temp_register(n + 1)
    rv = b.make_zeroed_temp_register(n + 1)
    with program(b, ra=ra, rb=rb, rm=rm, rp=rp, re=re, ru=ru, rv=rv) as p:
        p.control(p.rb[0], mask=0).apply(copy, p.rp, p.rv)
        p.control(p.rb[0]).apply(times_mod, p.ra, p.rp, p.rm, p.rv)
        p.apply(square_mod, p.ra, p.rm, p.ru)
        p.apply(exp_mod, p.ru, p.rb[1:k], p.rm, p.rv, p.re)
        p.apply(square_mod.inv, p.ra, p.rm, p.ru)
        p.control(p.rb[0]).apply(times_mod.inv, p.ra, p.rp, p.rm, p.rv)
        p.control(p.rb[0], mask=0).apply(copy.inv, p.rp, p.rv)
    ra, rb, rm, rp, re, ru, rv = p.results()
    b.return_zeroed_temp_register(ru)
    b.return_zeroed_temp_register(rv)
    return ra, rb, rm, rp, re
