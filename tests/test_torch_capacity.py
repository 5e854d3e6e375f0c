"""The bounded-scratch measurement passes of the port's capacity path
against the JAX package, at n = 12 with ``types.PASS_BLOCK`` cut to two
rows so that every pass runs in many blocks: the outcome probabilities
(``measure_probs_ri``, ``measure_probs``) within 1e-10 in float64, the
in-place collapse (``_collapse_``) and the public collapses built on it
exactly. The swap and reflection passes are in
``test_torch_capacity_passes.py``."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rustqip_tpu.ops import measurement_ops as RM  # noqa: E402

from rustqip_tpu_torch import types as port_types  # noqa: E402
from rustqip_tpu_torch.ops import measurement_ops as M  # noqa: E402

torch.set_num_threads(1)  # the test runner keeps one worker per core busy

TOL = 1e-10
C = 128


@pytest.fixture
def small_blocks(monkeypatch):
    """Blocks of 2 rows of 128 lanes: n = 12 (32 rows) runs in 16."""
    monkeypatch.setattr(port_types, "PASS_BLOCK", 1 << 8)


def _state(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return v / np.linalg.norm(v)


def _planes(v, dtype=torch.float64):
    R_ = v.size // C
    return (torch.tensor(v.real.reshape(R_, C), dtype=dtype),
            torch.tensor(v.imag.reshape(R_, C), dtype=dtype))


def _jnp(x):
    """A JAX copy of a CPU tensor: a JAX array may share a numpy buffer, and
    the port's in-place passes write theirs."""
    return jnp.asarray(x.numpy().copy())


@pytest.mark.parametrize("indices", [
    (3, 0, 11, 9), (1,), (4,), (8,), (2, 3), (11, 0, 6, 4, 2), tuple(range(12)), (),
], ids=["mixed4", "row_above_block", "row_in_block", "lane", "straddle", "shuffled5",
        "all12", "none"])
def test_probs_blocked_match_reference(small_blocks, indices):
    n = 12
    v = _state(n, 3)
    re, im = _planes(v)
    want = np.asarray(RM.measure_probs_ri(n, indices, _jnp(re), _jnp(im)))
    got = M.measure_probs_ri(n, indices, re, im).numpy()
    assert got.shape == want.shape and np.abs(got - want).max() <= TOL
    flat = M.measure_probs(n, indices, torch.as_tensor(v)).numpy()
    assert np.abs(flat - np.asarray(RM.measure_probs(n, indices, jnp.asarray(v)))).max() <= TOL


@pytest.mark.parametrize("indices, outcome", [
    ((3, 0, 11, 9), 5), ((1,), 1), ((4, 8), 2), ((2, 3), 3), ((11, 0, 6, 4, 2), 17),
], ids=["mixed4", "row_above_block", "row_and_lane", "straddle", "shuffled5"])
def test_collapse_in_place_matches_reference(small_blocks, indices, outcome):
    """``_collapse_`` writes the planes it is given and equals the JAX
    package's collapse exactly; the public functions return fresh planes
    and leave their input bit-equal."""
    n = 12
    v = _state(n, 5)
    re, im = _planes(v)
    prob = float(RM.measure_probs_ri(n, indices, _jnp(re), _jnp(im))[outcome])
    wr, wi = RM.measure_state_ri(n, indices, (outcome, prob), _jnp(re), _jnp(im))
    wr, wi = np.asarray(wr).reshape(-1, C), np.asarray(wi).reshape(-1, C)
    xr, xi = re.clone(), im.clone()
    ptrs = (xr.data_ptr(), xi.data_ptr())
    got = M._collapse_(n, indices, (outcome, prob), [xr, xi])
    assert (got[0].data_ptr(), got[1].data_ptr()) == ptrs
    assert np.array_equal(xr.numpy(), wr) and np.array_equal(xi.numpy(), wi)
    cr, ci = M.measure_state_ri(n, indices, (outcome, prob), re, im)
    assert cr.data_ptr() != re.data_ptr()
    assert np.array_equal(cr.numpy(), wr) and np.array_equal(ci.numpy(), wi)
    assert torch.equal(re, _planes(v)[0]) and torch.equal(im, _planes(v)[1])


def test_public_measure_functions_leave_input(small_blocks):
    """``measure_state``, ``measure`` and ``measure_ri`` never write their
    input; the flat collapse equals the JAX package's exactly, and a zero
    probability leaves the state as it is (a fresh copy)."""
    n, indices = 12, (2, 9)
    v = _state(n, 7)
    x = torch.as_tensor(v.copy())
    re, im = _planes(v)
    prob = float(M.measure_probs(n, indices, x)[1])
    got = M.measure_state(n, indices, (1, prob), x)
    want = np.asarray(RM.measure_state(n, indices, (1, prob), jnp.asarray(v)))
    assert np.array_equal(got.numpy(), want) and got.data_ptr() != x.data_ptr()
    same = M.measure_state(n, indices, (1, 0.0), x)
    assert torch.equal(same, x) and same.data_ptr() != x.data_ptr()
    M.measure(n, indices, x, measured=M.MeasuredCondition(2))
    M.measure_ri(n, indices, re, im, generator=torch.Generator().manual_seed(1))
    assert np.array_equal(x.numpy(), v)
    assert torch.equal(re, _planes(v)[0]) and torch.equal(im, _planes(v)[1])
