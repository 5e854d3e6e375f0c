"""The port's kernel path against the JAX package's per-op engine on the
parity windows (n=20, kernel windows through the window kernel's plain
version on the CPU, under the reference admission), and the strip
addressing of a window against the JAX package's ``_strip_index_map``.
Tolerance: 1e-6 max abs on normalized f32 states
(``scripts/kernel_parity.py``)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rustqip_tpu.engine import pallas_kernels as ref_pk  # noqa: E402
from rustqip_tpu.engine import real_apply as ref_ra  # noqa: E402

from rustqip_tpu_torch.engine import window_kernel as wk  # noqa: E402
from rustqip_tpu_torch.engine.admission import (  # noqa: E402
    TpuReferenceAdmission,
    window_seg_sizes,
)
from rustqip_tpu_torch.engine.parity_windows import build_sequences, lowr_sequence  # noqa: E402
from rustqip_tpu_torch.engine.real_apply import apply_ops_ri, compile_sweeps  # noqa: E402
from rustqip_tpu_torch.interop import planes_from_numpy, planes_to_numpy  # noqa: E402

torch.set_num_threads(1)  # the test runner keeps one worker per core busy

TOL = 1e-6


def _state(n, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return v / np.linalg.norm(v)


PARITY = build_sequences(20) + [lowr_sequence(20)]


@pytest.mark.parametrize("idx", range(len(PARITY)), ids=[s[0] for s in PARITY])
def test_parity_window_kernel_path_matches_reference_engine(idx):
    """The port's kernel path (kwindows through the plain version on the
    CPU) against the JAX package's per-op engine, at n=20."""
    name, ops, expected = PARITY[idx]
    n = 20
    ref_ops = _to_reference(ops)
    v = _state(n, 2)
    er = jnp.asarray(v.real)
    ei = jnp.asarray(v.imag)
    for op in ref_ops:
        er, ei = ref_ra.apply_op_ri(n, op, er, ei)
    want = np.asarray(er) + 1j * np.asarray(ei)
    sweeps = compile_sweeps(n, ops, True, TpuReferenceAdmission())
    assert all(k == "kwindow" for k, _, _ in sweeps), name
    pr, pi = planes_from_numpy(v, device="cpu")
    gr, gi = apply_ops_ri(n, ops, pr, pi, kernel_ok=True,
                          admission=TpuReferenceAdmission())
    assert np.abs(planes_to_numpy(gr, gi) - want).max() <= TOL


def _to_reference(ops):
    """Port ops -> the JAX package's ops (the parity windows only use
    dense, control and phase-product ops)."""
    from rustqip_tpu.ops import matrix_ops as R

    out = []
    for op in ops:
        kind = type(op).__name__
        if kind == "DenseOp":
            out.append(R.make_matrix_op(op.indices, op.data.reshape(-1)))
        elif kind == "ControlOp":
            inner = _to_reference([op.inner])[0]
            out.append(R.make_control_op(op.control_indices, inner))
        elif kind == "PhaseProductOp":
            out.append(R.PhaseProductOp(op.terms))
        else:
            raise TypeError(kind)
    return out


@pytest.mark.parametrize("hq", [(), (0,), (1, 4), (0, 2, 3), (2, 3, 5, 6)])
def test_strip_addressing_matches_reference(hq):
    """The CUDA kernel finds each CTA's rows by the formula of the ported
    ``_strip_index_map`` (the same as the reference's); the plain version
    takes the strips as reshape views. Both must name the same rows."""
    n = 16
    seg = tuple(window_seg_sizes(n, hq))
    prog = wk.encode_window(n, seg, [("low", np.eye(128))])
    bt = prog.bt
    sl = seg[-1] // bt
    rows = wk._strip_rows(prog, "cpu")
    for i in range(1 << len(hq)):
        port_map = wk._strip_index_map(seg, sl, i)
        ref_map = ref_pk._strip_index_map(seg, sl, i)
        for r in range(len(rows[i]) // bt):
            assert port_map(r) == ref_map(r)
            start = port_map(r)[0] * bt
            assert rows[i][r * bt : (r + 1) * bt].tolist() == list(
                range(start, start + bt)
            )
