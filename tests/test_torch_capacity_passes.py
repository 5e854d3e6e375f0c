"""The cross swap and the reflection of the port's capacity path against
the JAX package, at n = 10-12 with ``types.PASS_BLOCK`` cut to a few rows
so that each runs in many chunks: in place (``inplace=True``, as
``CompiledCircuit.run`` calls them on the planes it owns: the storage is
kept) and on copies (the input left bit-equal). The cross swap exactly,
the reflection within 1e-10 in float64."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rustqip_tpu.engine import apply as RA  # noqa: E402
from rustqip_tpu.ops import matrix_ops as R  # noqa: E402

from rustqip_tpu_torch import types as port_types  # noqa: E402
from rustqip_tpu_torch.engine import apply as port_apply  # noqa: E402
from rustqip_tpu_torch.engine.real_apply import apply_op_ri  # noqa: E402
from rustqip_tpu_torch.interop import op_from_reference  # noqa: E402

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


@pytest.mark.parametrize("n, cross", [
    (10, ((0, 9), (1, 8), (2, 7))),
    (12, ((0, 11), (1, 10), (2, 9), (3, 8), (4, 7))),
    (12, ((0, 7), (1, 11))),
    (11, ((1, 8), (0, 10))),
], ids=["n10_k3_qft", "n12_k5_qft", "n12_k2_scattered", "n11_k2_unsorted"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_cross_swap_exact(monkeypatch, n, cross, dtype):
    """The cross pass in row-group chunks equals the JAX package's staged
    pass exactly, in place (the storage kept) and on copies (the input
    left bit-equal)."""
    monkeypatch.setattr(port_types, "PASS_BLOCK", 1 << 9)
    re, im = _planes(_state(n, 11), dtype)
    wr, wi = (np.asarray(w) for w in RA._cross_swap_planes(n, list(cross), [_jnp(re), _jnp(im)]))
    keep = (re.clone(), im.clone())
    fresh = port_apply._cross_swap_planes(n, cross, [re, im])
    assert torch.equal(re, keep[0]) and torch.equal(im, keep[1])
    ptrs = (re.data_ptr(), im.data_ptr())
    owned = port_apply._cross_swap_planes(n, cross, [re, im], inplace=True)
    assert (owned[0].data_ptr(), owned[1].data_ptr()) == ptrs
    for got in (fresh, owned):
        assert np.array_equal(got[0].numpy(), wr) and np.array_equal(got[1].numpy(), wi)


@pytest.mark.parametrize("indices", [
    tuple(range(12)), (7, 8, 9, 10, 11), (2,), (0, 3, 4, 8, 10), tuple(range(10)),
], ids=["all12", "lanes_only", "one_row", "rows_and_lanes", "grover_sub10"])
def test_reflection_in_place_matches_reference(small_blocks, indices):
    n = 12
    v = _state(n, 13)
    re, im = _planes(v)
    ref_op = R.make_reflection_op(list(indices))
    want = [np.asarray(RA._apply_reflection_2d(n, ref_op, _jnp(x))) for x in (re, im)]
    op = op_from_reference(ref_op)
    fresh = apply_op_ri(n, op, re, im)
    assert torch.equal(re, _planes(v)[0]) and torch.equal(im, _planes(v)[1])
    ptrs = (re.data_ptr(), im.data_ptr())
    owned = apply_op_ri(n, op, re, im, inplace=True)
    assert (owned[0].data_ptr(), owned[1].data_ptr()) == ptrs
    for got in (fresh, owned):
        for g, w in zip(got, want):
            assert np.abs(g.numpy() - w.reshape(-1, C)).max() <= TOL


def test_reflection_staged_plan_in_place(monkeypatch):
    """A plan of more than one reshape stage keeps its staged sums and
    still updates an owned plane in place."""
    n, indices = 12, (0, 2, 4, 8)
    monkeypatch.setattr(port_apply, "MAX_RESHAPE_RANK", 5)
    assert len(port_apply._reflection_plan(n, indices)[1]) > 1
    re, _ = _planes(_state(n, 17))
    want = np.asarray(RA._apply_reflection_2d(n, R.make_reflection_op(list(indices)),
                                              _jnp(re)))
    op = op_from_reference(R.make_reflection_op(list(indices)))
    ptr = re.data_ptr()
    got = port_apply._apply_reflection_2d(n, op, re, inplace=True)
    assert got.data_ptr() == ptr
    assert np.abs(got.numpy() - want.reshape(-1, C)).max() <= TOL
