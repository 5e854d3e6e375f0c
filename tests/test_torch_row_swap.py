"""The swap pass on the CPU against the JAX package: ``row_swap.row_swap``
(which takes its plain version on CPU planes) equals the JAX package's
``_row_swap_planes`` bit for bit on the same seeded planes, the one wide
case takes the per-pair path, a controlled swap wider than ``DENSE_CAP``
matches the JAX package's ``apply_op_ri`` (1e-10 in f64, 1e-6 in f32), and
nothing is launched on the CPU. The cross kernel's host side: its tables
(``row_swap.cross_plan``) and its walk over tiles, emulated here in numpy
block by block as ``cross_row_swap_kernel`` takes them, move every element
as the plain cross and row passes and the JAX package's do (and as
``_cross_swap_perm`` moves a row group), each element read and written at
most once in place; ``apply_op_ri`` sends each part of a ``SwapOp`` to its
pass. The kernels themselves are held against the plain versions on the
card by ``test_torch_gpu_ops.py``, ``test_torch_gpu_swap.py`` and
``chip_smoke.py``."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rustqip_tpu.engine import apply as ref_apply_mod  # noqa: E402
from rustqip_tpu.engine.real_apply import apply_op_ri as ref_apply  # noqa: E402
from rustqip_tpu.ops import matrix_ops as R  # noqa: E402

from rustqip_tpu_torch.engine import apply as port_apply_mod  # noqa: E402
from rustqip_tpu_torch.engine import real_apply as port_real  # noqa: E402
from rustqip_tpu_torch.engine import copy_probe, cuda_build, row_swap  # noqa: E402
from rustqip_tpu_torch.engine.real_apply import apply_op_ri  # noqa: E402
from rustqip_tpu_torch.interop import (  # noqa: E402
    op_from_reference,
    planes_from_numpy,
    planes_to_numpy,
)
from rustqip_tpu_torch.ops import matrix_ops as P  # noqa: E402
from rustqip_tpu_torch.utils import observe  # noqa: E402

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
    cuda_build.reset_launch_counts()
    n = 14
    xr, xi = (torch.from_numpy(p) for p in _planes(n, 3))
    row_swap.row_swap(n, [(0, 6), (1, 5)], xr, xi)
    row_swap.cross_row_swap(n, [(0, 13), (1, 12)], [(2, 5)], xr, xi)
    apply_op_ri(n, P.make_swap_op([0, 1, 2], [13, 12, 5]), xr, xi, inplace=True)
    yr, yi = copy_probe.plane_copy(xr, xi, strips=4)
    assert torch.equal(yr, xr) and torch.equal(yi, xi)
    op = op_from_reference(R.make_control_op([0], R.make_swap_op([1, 2, 3, 4, 5, 6],
                                                                 [7, 8, 9, 10, 11, 12])))
    apply_op_ri(n, op, xr, xi)
    assert sum(cuda_build.LAUNCHES.values()) == 0


def test_bad_pair_sets_raise():
    xr, xi = (torch.from_numpy(p) for p in _planes(14, 4))
    for pairs in ([(0, 0)], [(0, 3), (3, 5)], [(2, 7)]):
        with pytest.raises(ValueError, match="pair set"):
            row_swap.row_swap(14, pairs, xr, xi)
    # cross sets the cross pass does not take: one pair; row qubits that are
    # not the top ones; a lane qubit twice; a lane qubit in a row's place
    for cross in ([(0, 13)], [(0, 13), (2, 12)], [(0, 13), (1, 13)], [(0, 13), (1, 6)]):
        with pytest.raises(ValueError, match="cross set"):
            row_swap.cross_row_swap(14, cross, [], xr, xi)
    with pytest.raises(ValueError, match="meet the cross pairs"):
        row_swap.cross_row_swap(14, [(0, 13), (1, 12)], [(1, 5)], xr, xi)


def _kernel_walk(n, plan, fresh):
    """(dest, source, reads): the flat index each element write of
    ``cross_row_swap_kernel`` lands on and the flat index it carries, and
    every flat index it loads, block by block as the kernel walks its
    units: 32 segments of 32 lanes a block, thread slot s in tile s >> c at
    row s & (2^c - 1); a tile's partner as the kernel forms it, P of the
    tile's first element ORed with P of the slot's tile offset; ownership
    by the two first elements; the lanes through the slots' exchange pi."""
    c = len(plan.slots)
    fbit = [f for f, _ in plan.slots]
    lbit = [lb for _, lb in plan.slots]

    def tile_base(t):
        x = np.asarray(t, dtype=np.int64) << 5
        for f in fbit:
            x = ((x >> f) << (f + 1)) | (x & ((1 << f) - 1))
        return x

    def partner(x):
        q = x.copy()
        for lo, hi in plan.pairs:
            d = ((x >> lo) ^ (x >> hi)) & 1
            q ^= (d << lo) | (d << hi)
        return q

    s = np.arange(32)[:, None]  # slot (segment) of a block
    x = np.arange(32)[None, :]  # lane in the segment
    sig, r = s >> c, s & ((1 << c) - 1)
    rowoff = sum(((r >> u) & 1) << f for u, f in enumerate(fbit))
    rs, xs = r + 0 * x, x + 0 * r  # pi: the source slot row and lane
    for u, lb in enumerate(lbit):
        rs = (rs & ~(1 << u)) | (((x >> lb) & 1) << u)
        xs = (xs & ~(1 << lb)) | (((r >> u) & 1) << lb)
    src_off = (((sig << c) | rs) * 32 + xs).reshape(-1)  # flat (slot, lane) of the source
    dsig = tile_base(sig)
    pdsig = partner(dsig)
    dests, srcs, reads = [], [], []
    for unit in range(plan.units):
        t0 = unit << (5 - c)
        b0 = tile_base(t0)
        a = b0 | dsig
        b = partner(b0) | pdsig
        active = (t0 + sig) < plan.tiles
        one = active & (fresh | (a <= b))
        two = active & (not fresh) & (a < b)
        at0 = b if fresh else a
        side0 = (at0 + rowoff + x).reshape(-1)
        side1 = (b + rowoff + x).reshape(-1)
        one_e, two_e = (np.broadcast_to(f, (32, 32)).reshape(-1) for f in (one, two))
        reads += [side0[one_e], side1[two_e]]
        da = (a + rowoff + x).reshape(-1)
        from_a = np.where(two_e, side1, side0)[src_off]
        dests += [da[one_e], (b + rowoff + x).reshape(-1)[two_e]]
        srcs += [from_a[one_e], side0[src_off][two_e]]
    return np.concatenate(dests), np.concatenate(srcs), np.concatenate(reads)


def _bit_swap_perm(n, pairs):
    idx = np.arange(1 << n, dtype=np.int64)
    out = idx.copy()
    for a, b in pairs:
        d = ((idx >> (n - 1 - a)) ^ (idx >> (n - 1 - b))) & 1
        out ^= (d << (n - 1 - a)) | (d << (n - 1 - b))
    return out


CROSS_CASES = [(16, name, pairs) for name, pairs in row_swap.cross_pair_sets(16)] + [
    (14, "qft14_cross_only", [(j, 13 - j) for j in range(7)]),
    (16, "k2_lane_bits_5_6_c0", [(0, 9), (1, 10), (3, 7)]),
    (16, "k4_lane_bits_4_6_0_2", [(0, 11), (1, 9), (2, 15), (3, 13), (4, 8)]),
    (9, "n9_k2_partial_unit", [(0, 8), (1, 4)]),
]


@pytest.mark.parametrize("n, name, pairs", CROSS_CASES, ids=[c[1] for c in CROSS_CASES])
def test_cross_kernel_walk_moves_as_the_plain_passes(n, name, pairs):
    """In place, every element the op moves is written once and read once,
    by the block that owns its tile, and no fixed element is touched
    twice; to fresh planes every element is written once. Both move the
    flat index as the op's bit swaps do, the cross part of every row group
    as ``_cross_swap_perm``, and seeded planes as the port's plain passes
    and the JAX package's, bit for bit."""
    op = P.make_swap_op([a for a, _ in pairs], [b for _, b in pairs])
    cross, rowp, colp, mixed = port_apply_mod._swap_schedule(n, op)
    assert len(cross) >= 2 and not colp and not mixed
    plan = row_swap.cross_plan(n, cross, rowp)
    want = _bit_swap_perm(n, pairs)
    xr, xi = _planes(n, len(pairs))
    flat = xr.reshape(-1)
    for fresh in (False, True):
        dest, src, reads = _kernel_walk(n, plan, fresh)
        assert np.array_equal(np.bincount(dest, minlength=1 << n) <= 1, np.ones(1 << n, bool))
        assert np.array_equal(src, want[dest])
        if fresh:
            assert dest.size == 1 << n
        else:
            assert np.bincount(reads, minlength=1 << n).max() <= 1
            assert np.array_equal(np.sort(reads), np.sort(dest))
            moved = np.flatnonzero(want != np.arange(1 << n))
            assert np.isin(moved, dest).all()
        out = flat.copy()
        out[dest] = flat[src]
        plain = row_swap.cross_row_swap(n, cross, rowp, torch.from_numpy(xr), torch.from_numpy(xi))
        assert np.array_equal(out.reshape(xr.shape), plain[0].numpy())
    k = len(cross)
    R = 1 << (n - 7)
    if not rowp:  # the cross part alone: every row group as _cross_swap_perm
        perm = port_apply_mod._cross_swap_perm(n, tuple(cross))
        for j in (0, (R >> k) - 1):
            g = np.arange((1 << k) * 128)
            flat_g = ((g // 128) * (R >> k) + j) * 128 + g % 128
            src_g = ((perm // 128) * (R >> k) + j) * 128 + perm % 128
            assert np.array_equal(want[flat_g], src_g)
    jr, ji = ref_apply_mod._cross_swap_planes(n, list(cross), [jnp.asarray(xr), jnp.asarray(xi)])
    if rowp:
        jr, ji = ref_apply_mod._row_swap_planes(n, rowp, [jr, ji])
    got = row_swap.cross_row_swap(n, cross, rowp, torch.from_numpy(xr), torch.from_numpy(xi))
    assert np.array_equal(got[0].numpy(), np.asarray(jr))
    assert np.array_equal(got[1].numpy(), np.asarray(ji))


#: (name, qubit pairs, the passes called with the kernels on, with them
#: off). On the CPU each kernel wrapper takes its reference, and the cross
#: reference takes the row reference for the op's row pairs.
DISPATCH_CASES = [
    ("rows_only", [(1, 5), (2, 4)], "row row_ref", "row_ref"),
    ("cross_and_rows", [(0, 13), (1, 12), (2, 5)], "cross cross_ref row_ref", "cross_ref row_ref"),
    ("cross_and_cols", [(0, 13), (1, 12), (7, 9)], "cross cross_ref col", "cross_ref col"),
    ("one_cross_pair", [(0, 13), (2, 5)], "row row_ref dense", "row_ref dense"),
    ("cross_off_the_top_rows", [(1, 13), (2, 12)], "dense dense", "dense dense"),
]


@pytest.mark.parametrize("name, pairs, on, off", DISPATCH_CASES,
                         ids=[c[0] for c in DISPATCH_CASES])
def test_swap_op_parts_go_to_their_passes(monkeypatch, name, pairs, on, off):
    """``apply_op_ri`` at n = 14: applicable cross pairs and the row pairs
    in one cross pass (``cross_row_swap`` or, with the kernels off, its
    reference), row pairs alone in ``row_swap`` (or its reference), column
    pairs as a lane relabel, other row-lane pairs as dense 4 x 4 passes;
    on the CPU nothing is counted as a plain cross fallback, and the
    result equals the op's bit swaps."""
    seen = []

    def spy(kind, fn):
        def wrapped(*args, **kw):
            seen.append(kind)
            return fn(*args, **kw)
        return wrapped

    for attr, kind in (("cross_row_swap", "cross"), ("cross_row_swap_reference", "cross_ref"),
                       ("row_swap", "row"), ("row_swap_reference", "row_ref")):
        monkeypatch.setattr(row_swap, attr, spy(kind, getattr(row_swap, attr)))
    monkeypatch.setattr(port_real, "_col_swap_planes", spy("col", port_real._col_swap_planes))
    monkeypatch.setattr(port_real, "_dense_ri", spy("dense", port_real._dense_ri))
    n = 14
    op = P.make_swap_op([a for a, _ in pairs], [b for _, b in pairs])
    xr, xi = _planes(n, 5, np.float64)
    perm = _bit_swap_perm(n, pairs)
    for swap_kernel, want in ((True, on), (False, off)):
        seen.clear()
        before = observe.COUNTS["swap_cross_plain"]
        got = apply_op_ri(n, op, torch.from_numpy(xr), torch.from_numpy(xi),
                          swap_kernel=swap_kernel)
        assert observe.COUNTS["swap_cross_plain"] == before
        assert sorted(seen) == sorted(want.split())
        assert np.array_equal(got[0].numpy().reshape(-1), xr.reshape(-1)[perm])
