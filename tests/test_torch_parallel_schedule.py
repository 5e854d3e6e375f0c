"""The port's shard schedule lowering (``parallel/shard_ops._lower_schedule``)
against the JAX package's, entry by entry and on the host only (no state is
run): the same kinds, indices, masks and payload arrays (within 1e-12) for an
op list that reaches every branch of ``_lower_op``, its error branch
included. Also the mesh constructors (the JAX package's checks and error
texts; no CPU fallback), the op-index dtype guard, and that no module of the
port, nor ``chip_smoke.py``, imports JAX or the JAX package."""

import ast
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rustqip_tpu.errors import CircuitError as RefCircuitError  # noqa: E402
from rustqip_tpu.ops import gates  # noqa: E402
from rustqip_tpu.ops import matrix_ops as R  # noqa: E402
from rustqip_tpu.parallel import mesh as ref_mesh  # noqa: E402
from rustqip_tpu.parallel import shard_ops as ref_shard_ops  # noqa: E402

from rustqip_tpu_torch.errors import CircuitError  # noqa: E402
from rustqip_tpu_torch.interop import op_from_reference  # noqa: E402
from rustqip_tpu_torch.parallel import make_multislice_mesh, make_shard_mesh  # noqa: E402
from rustqip_tpu_torch.parallel import mesh as port_mesh  # noqa: E402
from rustqip_tpu_torch.parallel import shard_ops  # noqa: E402

torch.set_num_threads(1)  # the test runner keeps one worker per core busy

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-12


def _u(k, seed):
    r = np.random.default_rng(seed)
    m = r.normal(size=(1 << k, 1 << k)) + 1j * r.normal(size=(1 << k, 1 << k))
    return np.linalg.qr(m)[0].reshape(-1)


def _xor_fn(row):
    return row ^ (((row >> 2) * 5 + 1) & 3), 1.0


def _phase_fn(row):
    return row, 1.0 - 2.0 * ((row & 3) == 3)


def _ops(n):
    """One op per branch of ``_lower_op`` on an n-qubit state (n = 7), in
    the JAX package's constructors."""
    H, X, Y = (m.reshape(-1) for m in (gates.H, gates.X, gates.Y))
    rng = np.random.default_rng(11)
    d1 = tuple(complex(v) for v in np.exp(1j * rng.uniform(-3, 3, 4)))
    d2 = tuple(complex(v) for v in np.exp(1j * rng.uniform(-3, 3, 8)))
    wide = R.make_fn_op(list(range(n)), _xor_fn, tag="xor", self_transpose=True)
    return {
        "local_batch": [R.make_matrix_op([4], H), R.make_matrix_op([n - 1], _u(1, 2))],
        "coalesced_swap": [R.make_swap_op([0, 1, 2], [n - 1, n - 2, n - 3])],
        "phase_product": [R.PhaseProductOp((((0, 5), d1), ((2, 1, 6), d2)))],
        "fndiag": [R.make_fn_op(list(range(n)), _phase_fn, tag="ph", diagonal=True)],
        "fndiag_controlled": [R.make_control_op(
            [n - 1], R.make_fn_op([0, 1, 4], _phase_fn, tag="cph", diagonal=True))],
        "reflect": [R.make_reflection_op(range(n)), R.make_reflection_op([1, n - 1])],
        "reflect_controlled": [R.make_control_op([0, n - 1], R.make_reflection_op([1, 2]))],
        "ctrl_global": [R.make_control_op([0, 2], R.make_matrix_op([5], X))],
        "ctrl_mixed": [R.make_control_op([1, 4], R.make_matrix_op([6], Y))],
        "exchange_dense": [R.make_matrix_op([2, 5], _u(2, 3)), R.make_matrix_op([0], Y)],
        "exchange_swap": [R.make_swap_op([1], [6])],
        "relocate_target": [R.make_control_op([5], R.make_matrix_op([1], X))],
        "relocate_two_globals": [R.make_matrix_op([0, 1], gates.CNOT.reshape(-1))],
        "relocate_partial": [R.make_matrix_op([0, 1, 2, 3, 4], _u(5, 5))],
        "multi_exchange": [R.make_matrix_op(list(range(n)), _u(n, 1))],
        "fold_control": [R.make_control_op([0, 1], R.make_matrix_op(list(range(2, n)), _u(n - 2, 6)))],
        "gex_fn": [wide],
        "gex_controlled_fn": [R.make_control_op([0], R.make_fn_op(
            list(range(1, n)), _xor_fn, tag="cxor", self_transpose=True))],
    }


def _same_op(ref_op, op):
    assert op_from_reference(ref_op) == op, (ref_op, op)


def _same_entry(a, b):
    """A JAX schedule entry ``a`` equals the port's ``b``."""
    kind = a[0]
    assert b[0] == kind
    if kind == "local":
        assert len(a[1]) == len(b[1])
        for x, y in zip(a[1], b[1]):
            _same_op(x, y)
    elif kind == "ctrl":
        assert a[1] == b[1]
        _same_op(a[2], b[2])
    elif kind == "exchange":
        assert a[1] == b[1] and a[3] == b[3]
        for ra, rb in zip(a[2], b[2]):
            for x, y in zip(ra, rb):
                np.testing.assert_allclose(y, x, atol=TOL, rtol=0)
    elif kind == "exchange_multi":
        assert a[1] == b[1] and a[3] == b[3] and a[4] == b[4]
        np.testing.assert_allclose(b[2], a[2], atol=TOL, rtol=0)
    elif kind == "diag":
        assert len(a[1]) == len(b[1])
        for (ia, ra, ima), (ib, rb, imb) in zip(a[1], b[1]):
            assert ia == ib
            np.testing.assert_allclose(rb, ra, atol=TOL, rtol=0)
            np.testing.assert_allclose(imb, ima, atol=TOL, rtol=0)
    elif kind == "fndiag":
        _same_op(a[1], b[1])
    elif kind == "reflect":
        _same_op(a[1], b[1])
        assert a[2:] == b[2:]
    elif kind == "gex":
        assert tuple(a[1]) == tuple(b[1]) and a[2] == b[2]
        pa, pb = a[3], b[3]
        assert pa[0] == pb[0]
        if pa[0] == "fn":
            _same_op(pa[1], pb[1])
        else:
            assert pa[1] == pb[1]
            np.testing.assert_array_equal(pb[2], pa[2])
            np.testing.assert_allclose(pb[3], pa[3], atol=TOL, rtol=0)
            np.testing.assert_allclose(pb[4], pa[4], atol=TOL, rtol=0)
    else:  # pragma: no cover
        raise AssertionError(kind)


def _both(n, g, ref_ops):
    want = ref_shard_ops._lower_schedule(n, g, ref_ops)
    got = shard_ops._lower_schedule(n, g, [op_from_reference(op) for op in ref_ops])
    assert [e[0] for e in got] == [e[0] for e in want]
    for a, b in zip(want, got):
        _same_entry(a, b)
    return [e[0] for e in got]


@pytest.mark.parametrize("g", [1, 2, 3])
def test_schedule_matches_jax_on_every_branch(g):
    n = 7
    kinds = set()
    for ops in _ops(n).values():
        kinds.update(_both(n, g, ops))
    if g == 3:
        assert kinds == {"local", "ctrl", "exchange", "exchange_multi", "diag",
                         "fndiag", "reflect", "gex"}


def test_schedule_branch_kinds_at_eight_shards():
    """Each branch of the op list lands where the JAX package sends it."""
    want = {
        "local_batch": ["local"],
        "coalesced_swap": ["exchange"] * 3,
        "phase_product": ["diag"],
        "fndiag": ["fndiag"],
        "fndiag_controlled": ["fndiag"],
        "reflect": ["reflect", "reflect"],
        "reflect_controlled": ["reflect"],
        "ctrl_global": ["ctrl"],
        "ctrl_mixed": ["ctrl"],
        "exchange_dense": ["exchange", "exchange"],
        "exchange_swap": ["exchange"],
        "relocate_target": ["exchange", "local", "exchange"],
        "relocate_two_globals": ["exchange", "exchange", "local", "exchange", "exchange"],
        "relocate_partial": ["exchange", "exchange", "exchange", "exchange", "exchange"],
        "multi_exchange": ["exchange_multi"],
        "fold_control": ["exchange_multi"],
        "gex_fn": ["gex"],
        "gex_controlled_fn": ["gex"],
    }
    for name, ops in _ops(7).items():
        assert _both(7, 3, ops) == want[name], name


def test_schedule_gex_sparse_payload_matches_jax():
    """A sparse op wider than DENSE_CAP on every qubit: the slot tables of
    the ``gex`` payload equal the JAX package's."""
    n = 11
    perm = np.random.default_rng(3).permutation(1 << n)
    ph = np.exp(1j * np.random.default_rng(4).uniform(-3, 3, 1 << n))
    rows = [[(int(perm[i]), complex(ph[i]))] for i in range(1 << n)]
    assert _both(n, 3, [R.make_sparse_matrix_op(list(range(n)), rows)]) == ["gex"]


def test_schedule_error_branch_matches_jax():
    """A dense op wider than DENSE_CAP with no free local slot raises in
    both packages with the same text."""
    n = 11
    op = R.make_matrix_op(list(range(n)), np.eye(1 << n).reshape(-1))
    with pytest.raises(RefCircuitError) as ref:
        ref_shard_ops._lower_schedule(n, 3, [op])
    with pytest.raises(CircuitError) as got:
        shard_ops._lower_schedule(n, 3, [op_from_reference(op)])
    assert str(got.value) == str(ref.value)


def test_controlled_fn_op_keeps_flags_and_selects():
    """``_controlled_fn_op``: the JAX package's tag and flags, and the
    control select inside ``fn`` (identity rows where a control is 0)."""
    inner = R.make_fn_op([1, 2, 3], _xor_fn, tag="x3", self_transpose=True)
    ref = ref_shard_ops._controlled_fn_op(R.make_control_op([0], inner))
    got = shard_ops._controlled_fn_op(op_from_reference(R.make_control_op([0], inner)))
    _same_op(ref, got)
    rows = torch.arange(16, dtype=torch.int32)
    col, val = got.fn(rows)
    rcol, rval = ref.fn(jnp.arange(16, dtype=jnp.int32))
    np.testing.assert_array_equal(col.numpy(), np.asarray(rcol))
    np.testing.assert_allclose(np.broadcast_to(val.numpy(), (16,)), np.asarray(rval))


def test_reflect_groups_and_index_dtype_match_jax():
    for g in (1, 2, 3):
        for gq in [(0,), (g - 1,), tuple(range(g))]:
            assert shard_ops._reflect_psum_groups(g, gq) == \
                ref_shard_ops._reflect_psum_groups(g, gq)
    assert jax.config.jax_enable_x64  # tests/conftest.py pins x64 on
    assert shard_ops._op_index_dtype(31) == torch.int32
    assert ref_shard_ops._op_index_dtype(31) == jnp.int32
    assert shard_ops._op_index_dtype(33) == torch.int64
    assert ref_shard_ops._op_index_dtype(33) == jnp.int64
    with pytest.raises(CircuitError, match="64 qubits"):
        shard_ops._op_index_dtype(64)


def test_mesh_checks_and_texts_match_jax():
    devs = jax.devices()[:8]
    mesh = make_shard_mesh(8, devices=["cpu"] * 8)
    assert mesh.size == 8 and mesh.shape == (8,) and mesh.axis_names == ("shard",)
    assert all(d == torch.device("cpu") for d in mesh.devices)
    assert make_shard_mesh(devices=["cpu"] * 6).size == 4  # largest power of two
    for call in (
        lambda mk, d: mk.make_shard_mesh(3, devices=d),
        lambda mk, d: mk.make_shard_mesh(16, devices=d),
        lambda mk, d: mk.make_multislice_mesh(3, 2, devices=d),
        lambda mk, d: mk.make_multislice_mesh(4, 4, devices=d),
    ):
        with pytest.raises(RefCircuitError) as ref:
            call(ref_mesh, devs)
        with pytest.raises(CircuitError) as got:
            call(port_mesh, ["cpu"] * 8)
        assert str(got.value) == str(ref.value)
    ms = make_multislice_mesh(2, 4, devices=["cpu"] * 8)
    assert ms.shape == (2, 4) and ms.axis_names == ("dcn", "shard") and ms.size == 8


def test_default_mesh_needs_cuda(monkeypatch):
    """No CPU fallback: without a CUDA device the default mesh raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(CircuitError, match="no CUDA device"):
        make_shard_mesh()
    with pytest.raises(CircuitError, match="no CUDA device"):
        make_multislice_mesh(2)


def test_explicit_geometry_rejects_multiaxis_mesh():
    with pytest.raises(CircuitError, match="1-D mesh"):
        shard_ops.make_sharded_pair(make_multislice_mesh(2, 4, devices=["cpu"] * 8), 7)


def test_port_imports_no_jax():
    """No module of the port and not ``chip_smoke.py`` imports JAX or the
    JAX package."""
    files = sorted((ROOT / "rustqip_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 40
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "rustqip_tpu"), (path, name)
