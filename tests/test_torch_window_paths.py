"""The window kernel's two paths, on the host: which windows the encoder
sends down the register-streaming path (``csrc/window_stream.cu``) and which
keep the tile path (``csrc/window_sweep.cu``) in the plans of QFT-28 and
Grover-28 with the H100's admission, the plans themselves unchanged, and the
``mix`` step encoded by its nonzeros: through ``window_sweep_reference``
against the dense coefficient table it replaced (1e-7) and against the JAX
package's Pallas kernel in interpret mode (f32, which is what that kernel
computes in; 1e-6 max abs on normalized states), with the butterfly
factors and diag hints the register path reads. The CUDA kernels
themselves are held against the plain version by ``test_torch_gpu.py``
and ``chip_smoke.py`` on the card."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rustqip_tpu.engine import pallas_kernels as ref_pk  # noqa: E402

from rustqip_tpu_torch import algos  # noqa: E402
from rustqip_tpu_torch.engine import compile as port_compile  # noqa: E402
from rustqip_tpu_torch.engine import window_kernel as wk  # noqa: E402
from rustqip_tpu_torch.engine.admission import (  # noqa: E402
    HOPPER,
    hopper_tile_rows,
    window_seg_sizes,
)
from rustqip_tpu_torch.engine.parity_windows import rand_u, step_windows  # noqa: E402
from rustqip_tpu_torch.interop import planes_from_numpy, planes_to_numpy  # noqa: E402
from rustqip_tpu_torch.prelude import LocalBuilder  # noqa: E402

torch.set_num_threads(1)  # the test runner keeps one worker per core busy

N = 12
MARKED = 0b1011001110001111000011110101  # chip_smoke.GROVER28_MARKED


def _state(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return v / np.linalg.norm(v)


def _plan28(monkeypatch, build):
    """Kernel windows of a 28-qubit circuit planned on the host with the
    H100's admission: [(seg, kernel steps, program)], and its sweep counts."""
    monkeypatch.setattr(port_compile, "for_device", lambda device: HOPPER)
    monkeypatch.setattr(port_compile, "_CACHE", {})
    b = LocalBuilder(dtype="f32", device="cpu", kernel_ok=True)
    build(b)
    cc = b.compile()
    wins = [p for s in cc.sweeps for k, p, _ in s if k == "kwindow"]
    return wins, cc.sweep_counts()


def _qft28(b):
    algos.qfft(b, b.register(28))


def _grover28(b):
    algos.grover_iteration(b, b.h(b.register(28)), MARKED, native_diffusion=False)


def _nonzeros(step, ns):
    return max(sum(step[1].get((j, i), 0) != 0 for i in range(ns)) for j in range(ns))


def test_qft28_windows_take_the_register_path(monkeypatch):
    wins, counts = _plan28(monkeypatch, _qft28)
    assert counts == {"kwindow": 6, "window": 0, "op": 1}  # PR 9's plan
    paths = [(p.h, p.path, p.kinds) for _, _, p in wins]
    assert paths == [(4, "registers", ("diag", "mix"))] * 3 + [
        (1, "registers", ("diag", "mix"))] * 2 + [(0, "tile", ("cbf", "diag", "low", "rbf"))]
    for seg, ksteps, prog in wins:
        if prog.h == 4:
            mixes = [s for s in ksteps if s[0] == "mix"]
            assert len(mixes) == 4 and all(_nonzeros(s, 16) == 2 for s in mixes)


def test_grover28_mix_only_windows_take_the_register_path(monkeypatch):
    wins, counts = _plan28(monkeypatch, _grover28)
    assert counts == {"kwindow": 30, "window": 0, "op": 0}  # PR 9's plan
    stream = [(seg, ks, p) for seg, ks, p in wins if p.path == "registers"]
    assert len(stream) == 19
    assert all(p.h == 4 and p.kinds == ("mix",) for _, _, p in stream)
    assert {_nonzeros(ks[0], 16) for _, ks, _ in stream} == {1, 16}
    for _, _, p in wins:
        if p.path == "tile":
            assert set(p.kinds) & {"rbf", "low", "lowr", "rmix"}


def test_register_path_leaves_the_plan_as_it_was(monkeypatch):
    """The plan does not see the path: every window's tile rows are the
    admission's and its tile fits the shared memory, whichever path it
    takes (the sweep counts are checked above)."""
    for build in (_qft28, _grover28):
        wins, _ = _plan28(monkeypatch, build)
        for seg, ksteps, prog in wins:
            has_rmix = any(s[0] == "rmix" for s in ksteps)
            assert prog.bt == hopper_tile_rows(prog.h, has_rmix, seg[-1])
            assert HOPPER.block_rows(prog.h, ksteps, seg[-1]) == prog.bt
            assert prog.smem_bytes <= 232448


def test_step_window_paths():
    """Strip-local step windows take the register path; windows with a
    row butterfly or a matrix step keep the tile path."""
    n = 16
    paths = {}
    for name, hq, ksteps, kinds in step_windows(n):
        prog = wk.encode_window(n, window_seg_sizes(n, hq), ksteps)
        paths[name] = prog.path
        assert (prog.path == "registers") == (kinds <= wk.STREAM_KINDS)
    assert sorted(k for k, v in paths.items() if v == "registers") == [
        "diag_cp_fan", "diag_many_groups", "diag_row_lane_mixed"]


# ---------------------------------------------------------------------------
# mix by its nonzeros
# ---------------------------------------------------------------------------

H2 = np.array([[1, 1], [1, -1]]) / np.sqrt(2)


def _controlled(h, u, ctrl_bit):
    """u on the other bits where window bit ``ctrl_bit`` is 1, the identity
    where it is 0 (those output strips are dead to the step)."""
    ns = 1 << h
    m = np.eye(ns, dtype=complex)
    on = [j for j in range(ns) if j >> ctrl_bit & 1]
    m[np.ix_(on, on)] = u
    return m


def _mixes(h):
    """{name: coefficient matrix}: dense, 2 nonzeros (H on one bit), 1
    nonzero (a permutation with phases), folded scalars (1, real,
    imaginary and complex terms side by side), a controlled mix whose
    control kills half the strips, and a projector that zeroes strips."""
    ns = 1 << h
    rng = np.random.default_rng(h)
    perm = rng.permutation(ns)
    p1 = np.zeros((ns, ns), dtype=complex)
    p1[np.arange(ns), perm] = np.exp(1j * rng.uniform(0, 2 * np.pi, ns))
    folded = np.zeros((ns, ns), dtype=complex)
    for j in range(ns):
        folded[j, j] = 1
        folded[j, (j + 1) % ns] = [0.5, -0.75j, 0.3 - 0.2j, 1][j % 4]
    return {
        "dense": rand_u(h, 5),
        "two_nonzeros": np.kron(H2, np.eye(ns // 2)),
        "one_nonzero": p1,
        "folded_scalars": folded,
        "controlled": _controlled(h, rand_u(h - 1, 6), h - 1),
        "killed_strips": np.kron(np.diag([1.0, 0.0]), np.eye(ns // 2)) @ np.kron(
            np.eye(ns // 2), H2),
    }


def _blocks(m):
    ns = m.shape[0]
    return {(j, i): complex(m[j, i]) for j in range(ns) for i in range(ns) if m[j, i] != 0}


def _dense_table(n, seg, m, v):
    """The replaced encoding's semantics, independently of the encoder: every
    output strip of an active row sums all NS inputs times an NS x NS complex
    table in float32 (4 products per term, zeros included); identity rows
    keep their strip."""
    prog = wk.encode_window(n, seg, [("mix", _blocks(m))])
    xr, xi = planes_from_numpy(v, device="cpu")
    vr, vi = wk._strip_views(prog, xr), wk._strip_views(prog, xi)
    ins = [(a.reshape(-1).clone(), b.reshape(-1).clone()) for a, b in zip(vr, vi)]
    cr = torch.tensor(m.real, dtype=torch.float32)
    ci = torch.tensor(m.imag, dtype=torch.float32)
    for j in range(m.shape[0]):
        if np.array_equal(m[j], np.eye(m.shape[0])[j]):
            continue
        ar = sum(cr[j, i] * x - ci[j, i] * y for i, (x, y) in enumerate(ins))
        ai = sum(cr[j, i] * y + ci[j, i] * x for i, (x, y) in enumerate(ins))
        vr[j].copy_(ar.view_as(vr[j]))
        vi[j].copy_(ai.view_as(vi[j]))
    return planes_to_numpy(xr, xi)


@pytest.mark.parametrize("name", sorted(_mixes(4)))
def test_compact_mix_matches_the_dense_table(name):
    m = _mixes(4)[name]
    n, hq = N, (0, 1, 2, 3)
    seg = window_seg_sizes(n, hq)
    v = _state(n, 11)
    prog = wk.encode_window(n, seg, [("mix", _blocks(m))])
    x = planes_from_numpy(v, device="cpu")
    wk.window_sweep_reference(n, *x, seg, [("mix", _blocks(m))], prog=prog)
    assert np.abs(planes_to_numpy(*x) - _dense_table(n, seg, m, v)).max() <= 1e-7


@pytest.mark.parametrize("name", ["dense", "one_nonzero", "folded_scalars", "controlled"])
def test_compact_mix_matches_reference_interpret(name):
    """The plain version of the compact encoding against the JAX package's
    kernel on the same window (h = 2: 4 strips at window bits 1 and 3)."""
    m = _mixes(2)[name]
    n, hq = N, (1, 3)
    seg = window_seg_sizes(n, hq)
    ksteps = [("mix", _blocks(m))]
    v = _state(n, 12)
    R = 1 << (n - 7)
    er, ei = ref_pk.window_sweep(
        n,
        jnp.asarray(v.real.astype(np.float32).reshape(R, 128)),
        jnp.asarray(v.imag.astype(np.float32).reshape(R, 128)),
        seg, ksteps, interpret=True,
    )
    want = np.asarray(er, np.float64).reshape(-1) + 1j * np.asarray(ei, np.float64).reshape(-1)
    x = planes_from_numpy(v, device="cpu")
    wk.window_sweep_reference(n, *x, seg, ksteps)
    assert np.abs(planes_to_numpy(*x) - want).max() <= 1e-6


def test_mix_terms_fold_like_scalar_pair():
    """Each output strip lists its inputs in order with _scalar_pair's
    cases as types (0 dropped, 1 passed through, real, imaginary, complex)
    and a row class for the register path's loops."""
    m = np.zeros((4, 4), dtype=complex)
    m[0, [0, 1, 2, 3]] = [1, 0.5, -2j, 0.3 + 0.4j]
    m[1, 1] = 1  # identity: inactive
    m[2, [1, 3]] = [0.25, -1]
    m[3, [0, 2]] = [1j, -0.5j]
    prog = wk.encode_window(N, window_seg_sizes(N, (1, 3)), [("mix", _blocks(m))])
    rec = prog.iprog[:8]
    assert wk.KINDS[rec[0]] == "mix" and rec[1] == 0b1101 and rec[2] % 4 == 0
    ent = prog.iprog.view(np.uint32)[rec[2] : rec[2] + 16].reshape(4, 4).astype(np.int64)
    T = (wk.T_ONE, wk.T_REAL, wk.T_IMAG, wk.T_CPLX)
    assert ent[0, 0] == 0b1111 and ent[0, 1] == sum(t << (2 * i) for i, t in enumerate(T))
    assert ent[0, 3] == 2 and ent[2, 3] == 0 and ent[3, 3] == 1
    np.testing.assert_allclose(
        prog.fprog[ent[0, 2] : ent[0, 2] + 8], [1, 0, 0.5, 0, 0, -2, 0.3, 0.4], rtol=1e-7)
    assert all(e[2] % 2 == 0 for e in ent[[0, 2, 3]])  # 8-byte aligned lists


@pytest.mark.parametrize("name", ["dense", "two_nonzeros", "killed_strips", "controlled"])
def test_mix_butterflies_reproduce_the_matrix(name):
    """A mix that factors into one 2 x 2 matrix per window bit (Grover's
    H on four bits, QFT's H on one, a projector beside H) is also written
    as butterflies for the register path; applying them in order gives
    M v. A matrix that does not factor gets none."""
    m = _mixes(4)[name]
    if name == "dense":
        m = np.kron(np.kron(H2, H2), np.kron(H2, H2))
    bfly = wk._mix_butterflies(_blocks(m), 16)
    if name == "controlled":
        assert bfly is None
        return
    v = np.random.default_rng(3).normal(size=(16, 5)) + 0j
    got = v.copy()
    for b, f in bfly:
        for j0 in (j for j in range(16) if not j >> b & 1):
            j1 = j0 | 1 << b
            got[j0], got[j1] = f[0, 0] * got[j0] + f[0, 1] * got[j1], f[1, 0] * got[j0] + f[1, 1] * got[j1]
    assert np.abs(got - m @ v).max() <= 1e-12
    prog = wk.encode_window(N, window_seg_sizes(N, (0, 1, 2, 3)), [("mix", _blocks(m))])
    rec = prog.iprog[:8]
    assert rec[3] == len(bfly) and list(prog.iprog[rec[4] : rec[4] + rec[3]]) == [b for b, _ in bfly]
    np.testing.assert_allclose(prog.fprog[rec[5] : rec[5] + 2].astype(complex)[0]
                               + 1j * prog.fprog[rec[5] + 1], bfly[0][1][0, 0], rtol=1e-6)


def test_qft_diag_records_carry_the_register_path_hint(monkeypatch):
    """QFT-28's h = 4 and h = 1 diag steps: no groups, factor mode, and two
    lane parts per step, each stored once and 16-byte aligned; the record
    names both and the strips of the second."""
    wins, _ = _plan28(monkeypatch, _qft28)
    seen = 0
    for _, _, prog in wins:
        if prog.path != "registers":
            continue
        ip = prog.iprog.view(np.uint32).astype(np.int64)
        for s in range(prog.nsteps):
            rec = ip[8 * s : 8 * s + 8]
            if wk.KINDS[rec[0]] != "diag":
                continue
            ents = {i: ip[rec[2] + 6 * i : rec[2] + 6 * i + 6] for i in range(1 << prog.h)
                    if rec[1] >> i & 1}
            los = {int(e[5]) for e in ents.values()}
            assert rec[4] == 1 and {rec[5], rec[6]} == los and len(los) == 2
            assert all(lo % 4 == 0 for lo in los)
            assert rec[7] == sum(1 << i for i, e in ents.items() if e[5] == rec[6])
            seen += 1
    assert seen == 3 * 4 + 2


def test_many_group_diag_has_no_hint():
    """A diag whose strips hold mixed groups (or angle mode) takes the
    register path's general loop: no hint in the record."""
    _, hq, ksteps, _ = {w[0]: w for w in step_windows(16)}["diag_many_groups"]
    prog = wk.encode_window(16, window_seg_sizes(16, hq), ksteps)
    assert prog.path == "registers" and prog.iprog[3] == 1 and prog.iprog[4] == 0
