"""Truth tables of every circuit in ``algos/arithmetic.py`` at the JAX
package's small sizes (``tests/test_algos.py``), port against JAX.

The port's harness runs a batch of initial basis states in ONE circuit run:
the initial state is the superposition of the rows' basis states
``|init_k>`` with distinct real amplitudes ``k + 1`` (normalized), and
since a classical reversible circuit permutes basis states, amplitude
``k + 1`` ends on exactly one basis state: row ``k``'s output. The JAX
package's harness ``vmap``s its compiled circuit over the same initial
indices. Both are held to the classical semantics and to each other; for
``exp_mod`` (whose JAX compile is the slowest of the suite) the port's
lowered pipeline is held op for op against the JAX package's instead of
running the JAX circuit again.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import rustqip_tpu.algos as jalgos  # noqa: E402
from rustqip_tpu.builder.builder import _lower_item as j_lower  # noqa: E402
from rustqip_tpu.prelude import LocalBuilder as JBuilder  # noqa: E402

import rustqip_tpu_torch.algos as talgos  # noqa: E402
from rustqip_tpu_torch.builder.builder import _lower_item as t_lower  # noqa: E402
from rustqip_tpu_torch.errors import CircuitError  # noqa: E402
from rustqip_tpu_torch.interop import op_from_reference  # noqa: E402
from rustqip_tpu_torch.ops.matrix_ops import op_fingerprint  # noqa: E402
from rustqip_tpu_torch.prelude import LocalBuilder as TBuilder  # noqa: E402


def decode(n, state_index, reg):
    """Register value from a state index (bit j = qubit reg.indices[j])."""
    v = 0
    for j, q in enumerate(reg.indices):
        v |= ((int(state_index) >> (n - 1 - q)) & 1) << j
    return v


def port_truth_table(b, init_regs, values, out_regs):
    """Outputs of the port's circuit on ``b`` for each row of ``values``,
    from one batched run: a list of tuples of ``out_regs`` values."""
    K = len(values)
    n = b.n
    idx = [b.initial_index(list(zip(init_regs, row))) for row in values]
    assert len(set(idx)) == K
    tag = np.arange(1, K + 1, dtype=np.float64)
    norm = np.linalg.norm(tag)
    state = np.zeros(1 << n, dtype=np.complex128)
    state[idx] = tag / norm
    re, im, _ = b.compile().run(initial_state=state)
    amp = (re.double() * norm).reshape(-1).numpy()
    assert im.double().abs().max().item() <= 1e-9
    hit = np.nonzero(np.abs(amp) > 0.5)[0]
    # a classical circuit permutes basis states, so amplitude k+1 marks
    # where the basis state of row k went
    assert len(hit) == K
    k_of = np.rint(amp[hit]).astype(np.int64) - 1
    assert np.allclose(amp[hit], k_of + 1, atol=1e-8)
    assert sorted(k_of) == list(range(K))
    by_k = dict(zip(k_of, hit))
    return [tuple(decode(n, by_k[k], r) for r in out_regs) for k in range(K)]


def jax_truth_table(b, init_regs, values, out_regs):
    """The JAX package's harness: its compiled circuit vmapped over the
    initial indices."""
    from rustqip_tpu.engine.apply import _geometry

    cc = b.compile()
    n = b.n
    _, _, C = _geometry(n)
    run = jax.vmap(lambda i: cc._fn(i // C, i % C, jax.random.PRNGKey(0))[:2])
    idx = [b.initial_index(list(zip(init_regs, row))) for row in values]
    re, im = run(jnp.asarray(idx, dtype=jnp.int32))
    probs = np.asarray(re) ** 2 + np.asarray(im) ** 2
    assert np.allclose(probs.max(axis=1), 1.0, atol=1e-8)
    return [
        tuple(decode(n, i, r) for r in out_regs) for i in np.argmax(probs, axis=1)
    ]


def _add(A, b, n=2, inv=False):
    regs = (b.register(n), b.register(n), b.register(n + 1))
    return regs, (A.add.inv if inv else A.add)(b, *regs)


def _add_mod(A, b, n=2):
    regs = (b.register(n), b.register(n + 1), b.register(n))
    return regs, A.add_mod(b, *regs)


def _shift(A, b, fn, n=3):
    r = b.register(n)
    return (r,), (getattr(A, fn)(b, r),)


def _copy(A, b, n=3):
    regs = (b.register(n), b.register(n))
    return regs, A.copy(b, *regs)


def _times_mod(A, b, n=2, k=2):
    regs = (b.register(n + 1), b.register(k), b.register(n), b.register(n + 1))
    return regs, A.times_mod(b, *regs)


def _square_mod(A, b, n=2):
    regs = (b.register(n + 1), b.register(n), b.register(n + 1))
    return regs, A.square_mod(b, *regs)


def _exp_mod(A, b, n, k):
    regs = tuple(b.register(s) for s in (n + 1, k, n, n + 1, n + 1))
    return regs, A.exp_mod(b, *regs)


def _rot(v, n, shift):
    return sum(1 << ((j + shift) % n) for j in range(n) if (v >> j) & 1)


#: name -> (build(A, b) -> (init regs, out regs), input rows, expected(row)),
#: the cases and sizes of the JAX package's tests/test_algos.py.
CASES = {
    "add": (
        _add,
        [(0, a, x) for a in range(4) for x in range(4)],
        lambda r: (0, r[1], r[1] + r[2]),
    ),
    "add_inverse": (
        lambda A, b: _add(A, b, inv=True),
        [(0, a, s) for a in range(4) for s in range(8)],
        lambda r: (0, r[1], (r[2] - r[1]) % 8),
    ),
    "add_mod": (
        _add_mod,
        [(a, x, m) for m in range(1, 4) for a in range(m) for x in range(m)],
        lambda r: (r[0], (r[0] + r[1]) % r[2], r[2]),
    ),
    "rshift": (
        lambda A, b: _shift(A, b, "rshift"),
        [(v,) for v in range(8)],
        lambda r: (_rot(r[0], 3, 1),),
    ),
    "lshift": (
        lambda A, b: _shift(A, b, "lshift"),
        [(v,) for v in range(8)],
        lambda r: (_rot(r[0], 3, -1),),
    ),
    "copy": (
        _copy,
        [(a, x) for a in range(8) for x in (0, 0b101)],
        lambda r: (r[0], r[0] ^ r[1]),
    ),
    "times_mod": (
        _times_mod,
        [(a, x, m, 0) for m in range(1, 4) for a in range(m) for x in range(4)],
        lambda r: (r[0], r[1], r[2], (r[1] * r[0]) % r[2]),
    ),
    "square_mod": (
        _square_mod,
        [(a, m, 0) for m in range(1, 4) for a in range(m)],
        lambda r: (r[0], r[1], (r[0] * r[0]) % r[1]),
    ),
}


@pytest.mark.parametrize("name", list(CASES))
def test_truth_table_matches_jax_and_semantics(name):
    build, rows, expected = CASES[name]
    tb = TBuilder(dtype="f64", device="cpu")
    t_in, t_out = build(talgos, tb)
    jb = JBuilder()
    j_in, j_out = build(jalgos, jb)
    got = port_truth_table(tb, t_in, rows, t_out)
    assert got == [expected(r) for r in rows]
    assert got == jax_truth_table(jb, j_in, rows, j_out)


def _pipeline_fingerprints(b, lower, convert):
    return [
        op_fingerprint(convert(e.op)) for item in b.pipeline for e in lower(item)
    ]


@pytest.mark.parametrize(
    "n,k,ms", [(2, 1, (2, 3)), (1, 2, (1,))], ids=["base_case", "recursive_small"]
)
def test_exp_mod_truth_table_and_ops_match_jax(n, k, ms):
    """e = (p * a^b) mod m: the base case (one exponent bit) and the
    smallest square-and-multiply recursion (k = 2, the degenerate m = 1)."""
    tb = TBuilder(dtype="f64", device="cpu")
    t_in, t_out = _exp_mod(talgos, tb, n, k)
    jb = JBuilder()
    _exp_mod(jalgos, jb, n, k)
    assert _pipeline_fingerprints(tb, t_lower, lambda op: op) == _pipeline_fingerprints(
        jb, j_lower, op_from_reference
    )
    rows = [
        (a, x, m, 1 % m, 0)
        for m in ms
        for a in range(min(1, m - 1), m)
        for x in range(1 << k)
    ]
    got = port_truth_table(tb, t_in, rows, t_out)
    assert [g[0] for g in got] == [r[0] for r in rows]
    assert [g[4] for g in got] == [(r[3] * r[0] ** r[1]) % r[2] for r in rows]


def test_arithmetic_size_checks_raise():
    b = TBuilder(device="cpu")
    with pytest.raises(CircuitError):
        talgos.add(b, b.register(2), b.register(2), b.register(2))
    with pytest.raises(CircuitError):
        talgos.add_mod(b, b.register(2), b.register(3), b.register(3))
    with pytest.raises(CircuitError):
        talgos.copy(b, b.register(2), b.register(3))
