"""The ``program``/``invertible`` DSL, port against JAX: the cases of
``tests/test_dsl.py`` (the reference's macro examples), each circuit's
unitary built once with each package's DSL and compared to 1e-10 in f64,
and to its closed form where the case has one."""

import types

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402
import rustqip_tpu.dsl as jdsl  # noqa: E402
from rustqip_tpu.prelude import LocalBuilder as JBuilder  # noqa: E402
from rustqip_tpu.prelude import make_circuit_matrix as j_matrix  # noqa: E402

import rustqip_tpu_torch.dsl as tdsl  # noqa: E402
from rustqip_tpu_torch.prelude import CircuitError  # noqa: E402
from rustqip_tpu_torch.prelude import LocalBuilder as TBuilder  # noqa: E402
from rustqip_tpu_torch.prelude import make_circuit_matrix as t_matrix  # noqa: E402

torch.set_num_threads(1)  # the test runner keeps one worker per core busy

TOL = 1e-10


def gamma(b, ra, rb):
    """The reference's README gamma: toffoli(ra->rb); toffoli(rb->ra)."""
    ra, rb = b.toffoli(ra, rb)
    rb, ra = b.toffoli(rb, ra)
    return ra, rb


def with_program(b, D):
    ra = b.register(3)
    rb = b.register(3)
    with D.program(b, ra=ra, rb=rb) as p:
        p.apply(gamma, p.ra[0:2], p.ra[2])
        p.apply(gamma, (p.ra[0], p.rb[0]), p.ra[2])
        p.apply(gamma, p.ra[0], (p.rb[0], p.ra[2]))
    ra, rb = p.results()
    return b.merge_two_registers(ra, rb)


def manual(b, D):
    ra = b.register(3)
    rb = b.register(3)
    ras = b.split_all_register(ra)
    rbs = b.split_all_register(rb)
    g1 = b.merge_registers([ras[0], ras[1]])
    g1, t1 = gamma(b, g1, ras[2])
    ras[0], ras[1] = b.split_all_register(g1)
    ras[2] = t1
    g2 = b.merge_registers([ras[0], rbs[0]])
    g2, t2 = gamma(b, g2, ras[2])
    ras[0], rbs[0] = b.split_all_register(g2)
    ras[2] = t2
    g3 = b.merge_registers([rbs[0], ras[2]])
    ras[0], g3 = gamma(b, ras[0], g3)
    rbs[0], ras[2] = b.split_all_register(g3)
    return b.merge_two_registers(b.merge_registers(ras), b.merge_registers(rbs))


def control_all_ones(b, D):
    ra = b.register(2)
    rb = b.register(2)
    with D.program(b, ra=ra, rb=rb) as p:
        p.control(p.rb).apply(D.ops.x, p.ra[0])
    ra, rb = p.results()
    return b.merge_two_registers(rb, ra)


def control_mask(b, D):
    ra = b.register(1)
    rb = b.register(2)
    with D.program(b, ra=ra, rb=rb) as p:
        p.control(p.rb, mask=0b01).apply(D.ops.x, p.ra)
    ra, rb = p.results()
    return b.merge_two_registers(rb, ra)


def nonregister_args(flag):
    def maybe_x(b, do_it, r):
        return b.x(r) if do_it else r

    def build(b, D):
        r = b.register(1)
        with D.program(b, r=r) as p:
            p.apply(maybe_x, flag, p.r)
        (r,) = p.results()
        return r

    return build


def invertible_roundtrip(b, D):
    @D.invertible
    def g(b, ra, rb):
        return gamma(b, ra, rb)

    ra = b.register(2)
    rb = b.register(1)
    with D.program(b, ra=ra, rb=rb) as p:
        p.apply(g, p.ra, p.rb)
        p.apply(g.inv, p.ra, p.rb)
    ra, rb = p.results()
    return b.merge_two_registers(ra, rb)


def invertible_with_args(flag):
    def build(b, D):
        @D.invertible
        def gamma_skip(b, skip, ra, rb):
            ra, rb = b.toffoli(ra, rb)
            if skip:
                rb, ra = b.toffoli(rb, ra)
            return ra, rb

        ra = b.register(2)
        rb = b.register(1)
        with D.program(b, ra=ra, rb=rb) as p:
            p.apply(gamma_skip, flag, p.ra, p.rb)
            p.apply(gamma_skip.inv, flag, p.ra, p.rb)
        ra, rb = p.results()
        return b.merge_two_registers(ra, rb)

    return build


def invertible_custom_name(b, D):
    @D.invertible(name="ungamma")
    def named(b, r):
        return b.t(r)

    assert named.inv.__name__ == "ungamma"
    r = b.register(1)
    return named.inv(b, named(b, r))


def half_inverted(b, D):
    """An @invertible line whose inverse is not applied: the unitary is the
    inverse alone, so the shadow-builder inversion itself is compared."""
    @D.invertible
    def g(b, ra, rb):
        ra = b.h(ra)
        ra, rb = gamma(b, ra, rb)
        return b.t(ra), rb

    ra = b.register(2)
    rb = b.register(1)
    with D.program(b, ra=ra, rb=rb) as p:
        p.apply(g.inv, p.ra, p.rb)
    ra, rb = p.results()
    return b.merge_two_registers(ra, rb)


def _control_all_ones_expected():
    # register order (rb, ra): X on ra[0] iff rb = 11
    e = np.eye(16)
    for s in range(16):
        if (s >> 2) == 0b11:
            e[s, s] = 0
            e[s, s ^ 0b10] = 1
    return e


def _control_mask_expected():
    # control(0b01): rb[0] == 1, rb[1] == 0 triggers (mask bit i = rb[i])
    e = np.eye(8)
    for s in range(8):
        if (s >> 2) & 1 == 1 and (s >> 1) & 1 == 0:
            e[s, s] = 0
            e[s, s ^ 1] = 1
    return e


#: name -> (build(b, D), closed form or None)
CASES = {
    "program_selectors": (with_program, None),
    "manual_selectors": (manual, None),
    "control_all_ones": (control_all_ones, _control_all_ones_expected()),
    "control_mask": (control_mask, _control_mask_expected()),
    "nonregister_true": (nonregister_args(True), np.array([[0, 1], [1, 0]])),
    "nonregister_false": (nonregister_args(False), np.eye(2)),
    "invertible_roundtrip": (invertible_roundtrip, np.eye(8)),
    "invertible_with_args_true": (invertible_with_args(True), np.eye(8)),
    "invertible_with_args_false": (invertible_with_args(False), np.eye(8)),
    "invertible_custom_name": (invertible_custom_name, np.eye(2)),
    "half_inverted": (half_inverted, None),
}


def unitary(pkg, build):
    if pkg == "port":
        b = TBuilder(dtype="f64", device="cpu")
        return t_matrix(b, build(b, tdsl))
    b = JBuilder()
    return j_matrix(b, build(b, jdsl))


@pytest.mark.parametrize("name", list(CASES))
def test_unitary_matches_jax(name):
    build, expected = CASES[name]
    got = unitary("port", build)
    assert np.abs(got - unitary("jax", build)).max() <= TOL
    if expected is not None:
        assert np.abs(got - expected).max() <= TOL


def test_program_equals_manual_construction():
    assert np.abs(unitary("port", with_program) - unitary("port", manual)).max() <= TOL


@pytest.mark.parametrize(
    "line,match",
    [
        (lambda p: p.apply(lambda bb, rr, flag: rr, p.r, True), "precede"),
        (lambda p: p.apply(gamma, p.r[0], p.r[0]), "twice"),
        (lambda p: p.apply(gamma), "selects no registers"),
    ],
    ids=["arg_order", "duplicate_qubit", "no_registers"],
)
def test_program_rejects_bad_lines(line, match):
    b = TBuilder(device="cpu")
    r = b.register(2)
    with pytest.raises(CircuitError, match=match):
        with tdsl.program(b, r=r) as p:
            line(p)


def test_inverse_example_end_to_end_matches_jax():
    """qip/examples/inverse_example.rs: h; control not -> a Bell pair."""
    probs = {}
    for name, B, D in (("port", TBuilder, tdsl), ("jax", JBuilder, jdsl)):
        b = B(dtype="f64", device="cpu") if name == "port" else B()
        ra = b.h(b.qubit())
        rb = b.qubit()
        with D.program(b, ra=ra, rb=rb) as p:
            p.control(p.ra).apply(lambda bb, r: bb.not_(r), p.rb)
        ra, rb = p.results()
        r, handle = b.measure_stochastic(b.merge_two_registers(ra, rb))
        _, measured = b.calculate_state(seed=0)
        probs[name] = np.asarray(measured.get_stochastic_measurement(handle))
    np.testing.assert_allclose(probs["port"], [0.5, 0, 0, 0.5], atol=TOL)
    np.testing.assert_allclose(probs["port"], probs["jax"], atol=TOL)


def test_dsl_exports_match_jax():
    assert set(tdsl.__all__) == set(jdsl.__all__)
    assert set(vars(tdsl.ops)) >= {k for k in vars(jdsl.ops) if not k.startswith("_")}
    assert isinstance(tdsl.ops, types.ModuleType)
