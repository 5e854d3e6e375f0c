"""The window kernel's tile path (``csrc/window_sweep.cu``), on the host.

What the encoder adds for the kernel is held against numpy emulations: B's
TF32 hi and lo parts (split on the host as ``cvt.rna.tf32.f32`` rounds),
their layout in the B stream (the kernel's wgmma k8 steps over it must give
x @ B^T), and the grouping of several tiles into one CTA (every row of the
state in exactly one slab, as ``_strip_index_map`` places it). Then every
tile-path window shape of ``parity_windows.tile_windows`` runs through
``window_sweep_reference`` of its encoded program and through the JAX
package's kernel in interpret mode on the same numpy inputs: 1e-6 max abs
in float32 on normalized states (``scripts/kernel_parity.py``'s bar). The
h <= 2 windows run at n = 12; the h = 3 and h = 4 windows need a 64- and a
128-row tile (8 strips x 8 or 16 rows), and the lane ladder's 128-row tile
needs n = 14: those run at n = 14. The CUDA kernel itself is held against
the plain version on the same windows by ``test_torch_gpu_tile.py`` (on
the card) and ``chip_smoke.py``."""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rustqip_tpu.engine import pallas_kernels as ref_pk  # noqa: E402

from rustqip_tpu_torch.engine import window_kernel as wk  # noqa: E402
from rustqip_tpu_torch.engine.admission import (  # noqa: E402
    HOPPER_SMEM_BYTES,
    window_seg_sizes,
)
from rustqip_tpu_torch.engine.parity_windows import (  # noqa: E402
    rand_u,
    real_orthogonal,
    tile_windows,
)
from rustqip_tpu_torch.interop import planes_from_numpy, planes_to_numpy  # noqa: E402

torch.set_num_threads(1)  # the test runner keeps one worker per core busy

TOL = 1e-6
# the windows each size runs against the JAX package (the h = 3 and h = 4
# windows exist from n = 13 and 14; the ladder's 128-row tile from n = 14)
CASES = [(12, name) for name in ("lowr_h0", "lane_window_h2_bt8", "rmix_h2_bt8",
                                 "cbf_low_lane_bits_h1", "mix_one_strip_in_h1")] + [
    (14, "lane_ladder_h0"), (14, "h3_cmix_rbf_lowr"), (14, "h4_table_mix_rbf_low")]


@functools.lru_cache(maxsize=None)
def _windows(n):
    """{name: window} of ``tile_windows(n)``, made once per process (their
    random unitaries are QR factorizations, which numpy may run on every
    core)."""
    return {w[0]: w for w in tile_windows(n)}


def _state(n, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return v / np.linalg.norm(v)


def _tf32_nearest(x):
    """Round float32 values to 10 explicit mantissa bits in float64 by
    their neighbours in the TF32 grid, ties away from zero (independent of
    the bit trick in ``tf32_round``)."""
    x64 = x.astype(np.float64)
    m, e = np.frexp(np.abs(x64))  # |x| = m 2^e, m in [0.5, 1)
    ulp = np.ldexp(1.0, e - 11)
    down = np.floor(np.abs(x64) / ulp) * ulp
    up = down + ulp
    pick = np.where(np.abs(x64) - down >= up - np.abs(x64), up, down)
    return (np.sign(x64) * pick).astype(np.float32)


def test_tf32_split_rounds_as_cvt_rna():
    """hi = tf32(x) keeps 10 explicit mantissa bits, rounded to nearest
    with ties away from zero; lo = tf32(x - hi); hi + lo is x within
    2^-22 |x|."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=4096) * np.exp2(rng.integers(-20, 20, 4096))).astype(np.float32)
    ties = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 3 * 2.0 ** -12 + 2.0 ** -22,
                     1.5 + 2.0 ** -11], dtype=np.float32)
    x = np.concatenate([x, ties, np.float32([0.0, 1.0, -2.5])])
    hi, lo = wk.tf32_split(x)
    assert not np.any(hi.view(np.uint32) & 0x1FFF)
    assert not np.any(lo.view(np.uint32) & 0x1FFF)
    np.testing.assert_array_equal(hi, _tf32_nearest(x))
    np.testing.assert_array_equal(hi[-7:-3], np.float32([1 + 2.0 ** -10, -(1 + 2.0 ** -10),
                                                        3 * 2.0 ** -12 + 2.0 ** -21,
                                                        1.5 + 2.0 ** -10]))
    np.testing.assert_array_equal(lo, _tf32_nearest((x - hi).astype(np.float32)))
    err = np.abs(x.astype(np.float64) - hi - lo)
    assert np.all(err <= 2.0 ** -22 * np.abs(x.astype(np.float64)))


@pytest.mark.parametrize("cplx", [False, True], ids=["real_b", "complex_b"])
def test_b_stream_layout_emulates_the_kernel_gemm(cplx):
    """The kernel's matrix step, emulated in numpy on one matrix's 8
    chunks: per chunk and k8 step, each thread's A slot q is x[r, 16 kc +
    4q + 2kk] and slot q + 4 the next k (one float4 feeds both steps), A
    split into TF32 hi/lo as ``split`` does, B read from the chunk parts
    as wgmma reads a no-swizzle K-major layout (core matrix (k core kq,
    lane core nc) at 128 kq + 256 nc bytes of the step, lane r of it at
    16 r bytes); lo.hi + hi.lo + hi.hi summed over all steps is x @ B^T to
    3xTF32 precision (complex: re = xr.Br - xi.Bi, im = xr.Bi + xi.Br)."""
    B = rand_u(7, 90) if cplx else real_orthogonal(91)
    Bre = np.real(B).astype(np.float32)
    Bim = np.imag(B).astype(np.float32) if cplx else None
    ch = wk.b_chunks(Bre, Bim)
    assert ch.shape == (8, (4 if cplx else 2) * 2048) and ch.dtype == np.float32
    rng = np.random.default_rng(92)
    x = (rng.normal(size=(64, 128)) + 1j * rng.normal(size=(64, 128))).astype(np.complex64)
    nc, kq, r, e = np.meshgrid(np.arange(16), np.arange(2), np.arange(8), np.arange(4),
                               indexing="ij")
    lane_of = (8 * nc + r).reshape(-1)
    slot_of = (4 * kq + e).reshape(-1)
    out = np.zeros((64, 128), np.complex128)
    for kc in range(8):
        for kk in range(2):
            k = [16 * kc + 4 * (j % 4) + 2 * kk + j // 4 for j in range(8)]
            parts = []
            for p in range(ch.shape[1] // 2048):
                step = ch[kc, p * 2048:(p + 1) * 2048].reshape(2, 16, 2, 8, 4)[kk]
                bk = np.zeros((128, 8))
                bk[lane_of, slot_of] = step.reshape(-1)  # [nc][kq][r][e] -> (lane, slot)
                parts.append(bk)

            def mma3(a, p):
                ah, al = wk.tf32_split(a.astype(np.float32))
                bh, bl = parts[2 * p], parts[2 * p + 1]
                return (al.astype(np.float64) @ bh.T + ah.astype(np.float64) @ bl.T
                        + ah.astype(np.float64) @ bh.T)

            ar, ai = x.real[:, k], x.imag[:, k]
            re, im = mma3(ar, 0), mma3(ai, 0)
            if cplx:
                re, im = re - mma3(ai, 1), im + mma3(ar, 1)
            out += re + 1j * im
    want = x.astype(np.complex128) @ (Bre + (0 if Bim is None else 1j * Bim.astype(np.float64))).T
    assert np.abs(out - want).max() <= 2e-6 * np.abs(want).max()


def _cta_slab_rows(prog):
    """The kernel's first row of every slab (tile t of CTA c, strip i), in
    numpy: its sbase computation."""
    h, bt, G = prog.h, prog.bt, prog.group
    seg = list(prog.seg_sizes)
    sl = seg[h] // bt
    n_ctas = (int(np.prod(seg)) // bt) // G
    rows = np.zeros((n_ctas, G << h), dtype=np.int64)
    for c in range(n_ctas):
        for s in range(G << h):
            i, tile = s % (1 << h), c * G + s // (1 << h)
            d, rest = tile % sl, tile // sl
            coord = [0] * h
            for j in range(h - 1, -1, -1):
                coord[j] = rest % seg[j]
                rest //= seg[j]
            blk = 0
            for j in range(h):
                blk = (blk * seg[j] + coord[j]) * 2 + ((i >> (h - 1 - j)) & 1)
            rows[c, s] = (blk * sl + d) * bt
    return rows


@pytest.mark.parametrize("n", [12, 14])
def test_grouped_tiles_cover_every_row_once(n):
    """Several tiles in one CTA: the slabs of all CTAs tile the state's
    rows exactly once, each slab a run of bt rows of its strip where the
    JAX package's ``_strip_index_map`` puts tile c * G + t, and a CTA holds
    at most 128 rows (64 with an rmix scratch) in at most 16 slabs."""
    grouped = 0
    for name, hq, ksteps, _ in _windows(n).values():
        seg = tuple(window_seg_sizes(n, hq))
        prog = wk.encode_window(n, seg, ksteps)
        h, bt, G = prog.h, prog.bt, prog.group
        assert G * bt << h <= (64 if prog.scratch else 128) and G << h <= 16
        grouped += G > 1
        rows = _cta_slab_rows(prog)
        cover = np.zeros(1 << (n - 7), dtype=np.int64)
        for c in range(rows.shape[0]):
            for s in range(rows.shape[1]):
                cover[rows[c, s]:rows[c, s] + bt] += 1
                want = ref_pk._strip_index_map(seg, seg[h] // bt, s % (1 << h))(
                    c * G + s // (1 << h))[0] * bt
                assert rows[c, s] == want, name
        assert np.all(cover == 1), name
    assert grouped >= (3 if n == 14 else 1)


def test_programs_fit_the_block_and_stream_every_matrix_use():
    """Every tile window at n = 12, 14, 20 and 28 fits one block's shared
    memory with a two-stage B ring; its chunk table walks the B stream
    in order, 8 chunks per matrix use (a low step, or each distinct matrix
    of an rmix step), 16 KiB for a real B and 32 KiB for a complex one."""
    assert {name for _, name in CASES} == set(_windows(14))  # every shape meets JAX
    for n in (12, 14, 20, 28):
        for name, hq, ksteps, _ in _windows(n).values():
            prog = wk.encode_window(n, window_seg_sizes(n, hq), ksteps)
            assert prog.path == "tile" and prog.smem_bytes <= HOPPER_SMEM_BYTES, name
            ip = prog.iprog
            uses = []
            for s in range(prog.nsteps):
                rec = ip[8 * s: 8 * s + 8]
                kind = wk.KINDS[rec[0]]
                if kind in ("low", "lowr"):
                    uses.append(kind == "low")
                elif kind == "rmix":
                    uses += [bool(c) for c in ip[rec[3]: rec[3] + 2 * rec[4]][1::2]]
            assert prog.nchunks == 8 * len(uses), name
            tab = ip[prog.chunk_tab: prog.chunk_tab + 2 * prog.nchunks].reshape(-1, 2)
            assert tab[:, 1].tolist() == [32768 if c else 16384 for c in uses for _ in range(8)]
            assert tab[:, 0].tolist() == ((np.cumsum(tab[:, 1]) - tab[:, 1]) // 16).tolist()
            assert prog.bstream.size * 4 == int(tab[:, 1].sum()) or not uses
            assert prog.nstage == (2 if uses else 0)
            assert prog.stage_bytes == max(tab[:, 1], default=0)


@pytest.mark.parametrize("n,name", CASES, ids=[f"{name}_n{n}" for n, name in CASES])
def test_tile_window_matches_reference_interpret(n, name):
    """The encoded program's plain version against the JAX package's kernel
    in interpret mode, f32, 1e-6 max abs on a normalized state."""
    _, hq, ksteps, kinds = _windows(n)[name]
    seg = window_seg_sizes(n, hq)
    v = _state(n, 93)
    R = 1 << (n - 7)
    er, ei = ref_pk.window_sweep(
        n,
        jnp.asarray(v.real.astype(np.float32).reshape(R, 128)),
        jnp.asarray(v.imag.astype(np.float32).reshape(R, 128)),
        seg, ksteps, interpret=True,
    )
    want = np.asarray(er, np.float64).reshape(-1) + 1j * np.asarray(ei, np.float64).reshape(-1)
    prog = wk.encode_window(n, seg, ksteps)
    assert set(prog.kinds) == kinds and prog.path == "tile"
    pr, pi = planes_from_numpy(v, device="cpu")
    wk.window_sweep_reference(n, pr, pi, seg, ksteps, prog=prog)
    assert np.abs(planes_to_numpy(pr, pi) - want).max() <= TOL


def test_out_planes_leave_the_input_alone():
    """``window_sweep(..., out=)`` writes fresh planes and leaves its input
    as it was (on the CPU through the plain version); ``c64_low_matmul``
    equals the JAX package's on the same input. A window that does not
    write every strip refuses ``out=``."""
    n = 12
    v = _state(n, 94)
    B = rand_u(7, 95)
    xr, xi = planes_from_numpy(v, device="cpu")
    keep = (xr.clone(), xi.clone())
    seg = (1 << (n - 7),)
    out = (torch.empty_like(xr), torch.empty_like(xi))
    got = wk.window_sweep(n, xr, xi, seg, [("low", B)], out=out)
    assert got[0] is out[0] and got[1] is out[1]
    assert torch.equal(xr, keep[0]) and torch.equal(xi, keep[1])
    R = 1 << (n - 7)
    er, ei = ref_pk.c64_low_matmul(
        jnp.asarray(v.real.astype(np.float32).reshape(R, 128)),
        jnp.asarray(v.imag.astype(np.float32).reshape(R, 128)), B)
    want = np.asarray(er, np.float64).reshape(-1) + 1j * np.asarray(ei, np.float64).reshape(-1)
    assert np.abs(planes_to_numpy(*got) - want).max() <= TOL
    _, hq, _, _ = _windows(n)["mix_one_strip_in_h1"]  # window bit at row bit 3
    with pytest.raises(ValueError, match="out="):
        wk.window_sweep(n, xr, xi, window_seg_sizes(n, hq),
                        [("cbf", 1, (0, 1, 1, 0), (("r", 3),))], out=out)
