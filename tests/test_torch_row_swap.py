"""The row-swap pass on the CPU against the JAX package: ``row_swap.row_swap``
(which takes its plain version on CPU planes) equals the JAX package's
``_row_swap_planes`` bit for bit on the same seeded planes, the one wide
case takes the per-pair path, a controlled swap wider than ``DENSE_CAP``
matches the JAX package's ``apply_op_ri`` (1e-10 in f64, 1e-6 in f32), and
nothing is launched on the CPU. The kernel itself is held against the plain
version on the card by ``test_torch_gpu.py`` and ``chip_smoke.py``."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rustqip_tpu.engine import apply as ref_apply_mod  # noqa: E402
from rustqip_tpu.engine.real_apply import apply_op_ri as ref_apply  # noqa: E402
from rustqip_tpu.ops import matrix_ops as R  # noqa: E402

from rustqip_tpu_torch.engine import apply as port_apply_mod  # noqa: E402
from rustqip_tpu_torch.engine import copy_probe, row_swap  # noqa: E402
from rustqip_tpu_torch.engine.real_apply import apply_op_ri  # noqa: E402
from rustqip_tpu_torch.interop import (  # noqa: E402
    op_from_reference,
    planes_from_numpy,
    planes_to_numpy,
)

torch.set_num_threads(1)  # the test runner keeps one worker per core busy

TOL = {"f64": 1e-10, "f32": 1e-6}


def _planes(n, seed, npd=np.float32):
    rng = np.random.default_rng(seed)
    shape = (1 << (n - 7), 128)
    return rng.normal(size=shape).astype(npd), rng.normal(size=shape).astype(npd)


def _jax_rows(n, pairs, xr, xi):
    out = ref_apply_mod._row_swap_planes(n, pairs, [jnp.asarray(xr), jnp.asarray(xi)])
    return [np.asarray(o) for o in out]


SETS_14 = row_swap.parity_pair_sets(14)


@pytest.mark.parametrize("idx", range(len(SETS_14)), ids=[s[0] for s in SETS_14])
def test_row_map_matches_jax(idx):
    """n = 14 (7 row qubits): a fused field reversal, scattered pairs (one
    permute per pair), a single pair, a field reaching the last row bit."""
    _, pairs = SETS_14[idx]
    n = 14
    xr, xi = _planes(n, idx)
    got = row_swap.row_swap(n, pairs, torch.from_numpy(xr), torch.from_numpy(xi))
    want = _jax_rows(n, pairs, xr, xi)
    assert np.array_equal(got[0].numpy(), want[0])
    assert np.array_equal(got[1].numpy(), want[1])


def test_parity_pair_sets_at_14_cover_each_path():
    n_m = 7
    fused = [port_apply_mod._row_field_reversal(n_m, p) for _, p in SETS_14]
    assert any(f is not None for f in fused) and any(f is None for f in fused)
    assert any(len(p) == 1 for _, p in SETS_14)
    assert any(max(max(q) for q in p) == n_m - 1 for _, p in SETS_14)


def test_span_17_takes_the_per_pair_path_and_matches_jax():
    n = 24  # 17 row qubits: reversing all of them is span 17 > 16
    pairs = [(t, 16 - t) for t in range(8)]
    assert port_apply_mod._row_field_reversal(n - 7, pairs) is None
    xr, xi = _planes(n, 17)
    got = row_swap.row_swap(n, pairs, torch.from_numpy(xr), torch.from_numpy(xi))
    want = _jax_rows(n, pairs, xr, xi)
    assert np.array_equal(got[0].numpy(), want[0])
    assert np.array_equal(got[1].numpy(), want[1])


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_conditioned_wide_swap_matches_jax(prec):
    """A ControlOp whose inner SwapOp is wider than DENSE_CAP: the inner op
    runs on copies of the planes, then the control selects."""
    n = 14
    op = R.make_control_op([0], R.make_swap_op([1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]))
    assert op.num_indices > port_apply_mod.DENSE_CAP
    rng = np.random.default_rng(9)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    v /= np.linalg.norm(v)
    npd = np.float64 if prec == "f64" else np.float32
    er, ei = ref_apply(n, op, jnp.asarray(v.real.astype(npd)), jnp.asarray(v.imag.astype(npd)))
    want = np.asarray(er, np.float64) + 1j * np.asarray(ei, np.float64)
    td = torch.float64 if prec == "f64" else torch.float32
    pr, pi = planes_from_numpy(v, dtype=td, device="cpu")
    keep = (pr.clone(), pi.clone())
    got = planes_to_numpy(*apply_op_ri(n, op_from_reference(op), pr, pi))
    assert np.abs(got - want).max() <= TOL[prec]
    assert torch.equal(pr, keep[0]) and torch.equal(pi, keep[1])


def test_nothing_is_launched_on_the_cpu():
    row_swap.reset_launch_counts()
    copy_probe.reset_launch_counts()
    n = 14
    xr, xi = (torch.from_numpy(p) for p in _planes(n, 3))
    row_swap.row_swap(n, [(0, 6), (1, 5)], xr, xi)
    yr, yi = copy_probe.plane_copy(xr, xi, strips=4)
    assert torch.equal(yr, xr) and torch.equal(yi, xi)
    op = op_from_reference(R.make_control_op([0], R.make_swap_op([1, 2, 3, 4, 5, 6],
                                                                 [7, 8, 9, 10, 11, 12])))
    apply_op_ri(n, op, xr, xi)
    assert sum(row_swap.LAUNCHES.values()) == 0
    assert sum(copy_probe.LAUNCHES.values()) == 0


def test_bad_pair_sets_raise():
    xr, xi = (torch.from_numpy(p) for p in _planes(14, 4))
    for pairs in ([(0, 0)], [(0, 3), (3, 5)], [(2, 7)]):
        with pytest.raises(ValueError, match="pair set"):
            row_swap.row_swap(14, pairs, xr, xi)
