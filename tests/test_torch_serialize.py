"""Circuit serialization in the port against the JAX package (twins of the
serialize half of ``test_aux.py`` and the serialize -> replay half of
``test_robustness.py``): a circuit built the same way in both packages
serializes to the same JSON text, a text written by either package loads
in the other, and the replayed circuit gives the JAX package's state within
1e-10 in float64 (the port forced to the JAX run's collapse outcomes).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from rustqip_tpu.prelude import LocalBuilder as JB  # noqa: E402
from rustqip_tpu.utils import serialize as JS  # noqa: E402

from rustqip_tpu_torch.errors import CircuitError  # noqa: E402
from rustqip_tpu_torch.prelude import LocalBuilder as PB  # noqa: E402
from rustqip_tpu_torch.utils import serialize as PS  # noqa: E402

torch.set_num_threads(1)  # the test runner keeps one worker per core busy

F64 = np.complex128
TOL = 1e-10


def build_example(b):
    q, r = b.qubit(), b.register(2)
    q = b.h(q)
    q = b.rz_pi_by(q, 4)
    q = b.rz(q, 0.123)
    q = b.apply_global_phase(q, 0.5)
    cb = b.condition_with(q)
    r = cb.apply_vec_matrix(r, np.eye(4).reshape(-1))
    q = cb.dissolve()
    r = b.repeat(3, lambda bb, rr: bb.h(bb.h(rr)), r)
    r, m = b.measure(r)
    q, s = b.measure_stochastic(q)
    return m, s


def random_circuit(b, rng, n=6, depth=18):
    """``test_robustness._random_circuit`` on either package's builder."""
    qs = b.split_all_register(b.register(n))

    def rand_u(k):
        m = rng.normal(size=(1 << k, 1 << k)) + 1j * rng.normal(size=(1 << k, 1 << k))
        return np.linalg.qr(m)[0]

    for _ in range(depth):
        kind = rng.integers(0, 8)
        i, j, k = rng.choice(n, size=3, replace=False)
        if kind == 0:
            qs[i] = getattr(b, rng.choice(["h", "x", "y", "z", "s", "t"]))(qs[i])
        elif kind == 1:
            qs[i], qs[j] = b.cnot(qs[i], qs[j])
        elif kind == 2:
            qs[i], qs[j] = b.swap(qs[i], qs[j])
        elif kind == 3:
            qs[i] = b.rz(qs[i], float(rng.uniform(-3, 3)))
        elif kind == 4:
            qs[i] = b.apply_matrix(qs[i], rand_u(1))
        elif kind == 5:
            merged = b.apply_matrix(b.merge_two_registers(qs[i], qs[j]), rand_u(2))
            qs[i], qs[j] = b.split_all_register(merged)
        elif kind == 6:
            cb = b.condition_with(qs[i])
            qs[j] = cb.apply_matrix(qs[j], rand_u(1))
            qs[i] = cb.dissolve()
        else:
            perm = rng.permutation(4)
            ph = np.exp(1j * rng.uniform(-3, 3, 4))
            rows = [[(int(perm[t]), complex(ph[t]))] for t in range(4)]
            merged = b.apply_sparse_matrix(b.merge_two_registers(qs[i], qs[j]), rows)
            qs[i], qs[j] = b.split_all_register(merged)


def _replay_matches(jb, port_b, seed, ordinals=()):
    """The port builder's state equals the JAX builder's, the port forced
    to the JAX run's collapse outcomes (``ordinals``: the ordinals of the
    collapsing measurements)."""
    js, jm = jb.calculate_state(seed=seed)
    conditions = {i: int(jm._results[i][0]) for i in ordinals}
    ps, pm = port_b.calculate_state(seed=seed, conditions=conditions or None)
    np.testing.assert_allclose(ps, js, atol=TOL, rtol=0)
    return jm, pm


def test_circuit_json_equals_jax_and_loads_both_ways():
    jb, pb = JB(dtype=F64), PB(dtype=F64, device="cpu")
    (jm, js), (pm, ps) = build_example(jb), build_example(pb)
    text = PS.circuit_to_json(pb)
    assert text == JS.circuit_to_json(jb)
    port_from_jax = PS.builder_from_json(JS.circuit_to_json(jb), dtype=F64, device="cpu")
    jax_from_port = JS.builder_from_json(text, dtype=F64)
    assert port_from_jax.n == pb.n and len(port_from_jax.pipeline) == len(pb.pipeline)
    for (i1, c1), (i2, c2) in zip(pb.pipeline, port_from_jax.pipeline):
        assert i1 == i2 and c1.fingerprint() == c2.fingerprint()
    assert JS.circuit_to_json(jax_from_port) == text
    # measurement ordinal 0 collapses, ordinal 1 is stochastic
    jres, pres = _replay_matches(jax_from_port, port_from_jax, 3, [0])
    np.testing.assert_allclose(pres._results[1], np.asarray(jres._results[1]), atol=TOL)


def test_replayed_builder_compiles_to_the_original_plan():
    """A builder rebuilt from JSON on a kernel-path CPU builder plans the
    same sweeps as the original (segments and sweep kinds)."""
    from rustqip_tpu_torch.algos import qfft

    b = PB(dtype="f32", device="cpu", kernel_ok=True)
    qfft(b, b.register(14))
    b2 = PS.builder_from_json(PS.circuit_to_json(b), dtype="f32", device="cpu",
                              kernel_ok=True)
    c1, c2 = b.compile(), b2.compile()
    assert c1 is c2  # same fingerprint: the compile cache hands back one plan
    assert c1.sweep_counts()["kwindow"] > 0 and c2.sweep_counts() == c1.sweep_counts()


def test_circuit_file_roundtrip(tmp_path):
    jb, pb = JB(dtype=F64), PB(dtype=F64, device="cpu")
    build_example(jb)
    build_example(pb)
    PS.save_circuit(pb, tmp_path / "port.json")
    JS.save_circuit(jb, tmp_path / "jax.json")
    text = (tmp_path / "port.json").read_text()
    assert text == (tmp_path / "jax.json").read_text()
    b2 = PS.load_circuit(tmp_path / "jax.json", dtype=F64, device="cpu")
    assert PS.circuit_to_json(b2) == text


def test_state_snapshot_roundtrip(tmp_path):
    """A complex array and the engine's torch planes both save; either
    package loads what the other saved."""
    import torch

    from rustqip_tpu_torch.interop import planes_from_numpy

    b = PB(dtype=F64, device="cpu")
    b.h(b.register(3))
    state, _ = b.calculate_state()
    PS.save_state(tmp_path / "a.npz", state)
    np.testing.assert_allclose(JS.load_state(tmp_path / "a.npz"), state, atol=1e-12)
    re, im = planes_from_numpy(state, dtype=torch.float64)
    PS.save_state(tmp_path / "b.npz", re, im)
    np.testing.assert_allclose(PS.load_state(tmp_path / "b.npz").reshape(-1), state,
                               atol=1e-12)
    JS.save_state(tmp_path / "c.npz", state)
    np.testing.assert_allclose(PS.load_state(tmp_path / "c.npz"), state, atol=1e-12)


@pytest.mark.parametrize("seed", range(6))
def test_serialize_replay_fuzz(seed):
    """The JAX file's fuzz circuits: the same JSON in both packages, the
    port's replay of the JAX text equal to the JAX state, and a double
    round trip byte-identical."""
    jb, pb = JB(dtype=F64), PB(dtype=F64, device="cpu")
    random_circuit(jb, np.random.default_rng(seed))
    random_circuit(pb, np.random.default_rng(seed))
    text = JS.circuit_to_json(jb)
    assert PS.circuit_to_json(pb) == text
    b2 = PS.builder_from_json(text, dtype=F64, device="cpu")
    _replay_matches(jb, b2, 99)
    assert PS.circuit_to_json(b2) == text


def test_serialize_replay_with_measurements():
    def build(b):
        qs = b.split_all_register(b.register(4))
        qs[0] = b.h(qs[0])
        qs[0], qs[1] = b.cnot(qs[0], qs[1])
        _, m = b.measure(b.merge_two_registers(qs[0], qs[1]))
        b.measure_stochastic(b.merge_two_registers(qs[2], qs[3]))
        return m

    jb, pb = JB(dtype=F64), PB(dtype=F64, device="cpu")
    build(jb)
    m = build(pb)
    b2 = PS.builder_from_json(PS.circuit_to_json(pb), dtype=F64, device="cpu")
    assert b2._measurement_kinds == ["collapse", "stochastic"]
    jres, pres = _replay_matches(jb, b2, 7, [0])
    assert pres._results[0][0] == jres.get_measurement(m)[0]
    with pytest.raises(CircuitError):
        b2.calculate_state(seed=0, conditions={1: 0})
    b2.calculate_state(seed=0, conditions={0: 1})


@pytest.mark.parametrize("controlled", [False, True], ids=["plain", "controlled"])
def test_function_gate_refuses_to_serialize(controlled):
    """A function gate is a Python callable, not data: both packages raise
    ``CircuitError``."""
    from rustqip_tpu.errors import CircuitError as JError

    for B, Err, kw in ((JB, JError, {}), (PB, CircuitError, {"device": "cpu"})):
        b = B(dtype=F64, **kw)
        c, r = b.qubit(), b.register(2)
        if controlled:
            cb = b.condition_with(c)
            cb.apply_fn_matrix(r, lambda row: ((row + 1) % 4, 1.0), tag="inc")
            cb.dissolve()
        else:
            b.apply_fn_matrix(r, lambda row: ((row + 1) % 4, 1.0), tag="inc")
        with pytest.raises(Err, match="Cannot serialize"):
            (JS if B is JB else PS).circuit_to_json(b)
