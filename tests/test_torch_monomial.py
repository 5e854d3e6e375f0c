"""The monomial pass on the CPU (``engine/monomial.py``): the host check on
permutations, permutations with phases, diagonals and near-monomial
matrices (refused) and controlled ops; the plain pass equal exactly (max
abs 0) to the route it replaces (``real_apply._dense_ri`` and the
controlled select) on random monomial ops at n <= 12, targets on lanes, on
rows and on both, 0 to 3 controls, in place and on copies; a numpy
emulation of the kernel's tables and tiles (``csrc/monomial_pass.cu``)
equal to the plain pass; its count, bytes and span; Shor at n = 13 (10
work qubits, N = 1007, t = 3), which takes the pass, within 1e-6 of the
JAX package's; and host-only plans with the H100's admission: QFT-32,
QPE-28 (m = 27) and QV-28 plan no monomial pass, Shor-31 (t = 21) plans
exactly 21 beside its kernel windows, its dense head and its swap.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rustqip_tpu.algos import shor_period_circuit as j_shor
from rustqip_tpu.prelude import LocalBuilder as JBuilder
from rustqip_tpu_torch.algos.shor import shor_period_circuit
from rustqip_tpu_torch.engine import compile as port_compile
from rustqip_tpu_torch.engine import monomial, real_apply
from rustqip_tpu_torch.engine.admission import HOPPER
from rustqip_tpu_torch.engine.apply import DENSE_CAP, _control_mask_2d
from rustqip_tpu_torch.engine.compile import MeasureEntry
from rustqip_tpu_torch.ops.matrix_ops import (
    ControlOp,
    DenseOp,
    SparseOp,
    SwapOp,
    make_control_op,
    op_to_dense,
)
from rustqip_tpu_torch.prelude import LocalBuilder
from rustqip_tpu_torch.types import geometry
from rustqip_tpu_torch.utils import observe

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.circuits import qft as qft_circuit  # noqa: E402
from portbench.circuits import qpe as qpe_circuit  # noqa: E402
from portbench.circuits import qv as qv_circuit  # noqa: E402

torch.set_num_threads(1)  # the test runner keeps one worker per core busy


def _monomial_matrix(rng, k, phases=True):
    perm = rng.permutation(1 << k)
    while np.array_equal(perm, np.arange(1 << k)):
        perm = rng.permutation(1 << k)
    mat = np.zeros((1 << k, 1 << k), dtype=np.complex128)
    mat[perm, np.arange(1 << k)] = np.exp(2j * np.pi * rng.random(1 << k)) if phases else 1
    return mat


def _sparse(mat, indices):
    rows = tuple(tuple((int(c), complex(mat[r, c])) for c in np.flatnonzero(mat[r]))
                 for r in range(mat.shape[0]))
    return SparseOp(tuple(indices), rows)


def _case(name):
    rng = np.random.default_rng(5)
    perm = _monomial_matrix(rng, 3, phases=False)
    with_phase = _monomial_matrix(rng, 3)
    diag = np.diag(np.exp(1j * rng.random(8)))
    near = perm.copy()
    near[0, np.flatnonzero(perm[1])[0]] = 1e-300  # a second nonzero in one column
    swap = SwapOp((0, 1))
    cases = {
        "permutation": (DenseOp((4, 1, 6), perm), True),
        "phases": (DenseOp((2, 7, 3), with_phase), True),
        "diagonal": (DenseOp((4, 1, 6), diag), False),
        "near_monomial": (DenseOp((4, 1, 6), near), False),
        "controlled": (make_control_op([0, 5], DenseOp((4, 1, 6), with_phase)), True),
        "controlled_sparse": (make_control_op([9], _sparse(with_phase, (4, 1, 6))), True),
        "controlled_diagonal": (make_control_op([0], DenseOp((4, 1, 6), diag)), False),
        "controlled_swap": (make_control_op([0], swap), False),
    }
    return cases[name]



@pytest.mark.parametrize("name", ["permutation", "phases", "diagonal", "near_monomial",
                                  "controlled", "controlled_sparse", "controlled_diagonal",
                                  "controlled_swap"])
def test_the_check(name):
    """Exact: one nonzero in every row and column, compared to 0 (a 1e-300
    entry refuses the op), and not diagonal; the plan's places and phases
    are the matrix's, read through the flat index bits."""
    n = 14
    op, monomial_op = _case(name)
    plan = monomial.plan_of(n, op)
    assert (plan is not None) is monomial_op
    if plan is None:
        return
    assert monomial.plan_of(n, op) is plan  # worked out once per op and n
    inner = op.inner if isinstance(op, ControlOp) else op
    targets = op.target_indices if isinstance(op, ControlOp) else op.indices
    mat = op_to_dense(inner)
    k = len(targets)
    # the plan's (src, phase) in the matrix's own index order
    local = np.zeros(1 << k, dtype=np.int64)
    for j, q in enumerate(targets):
        local |= ((np.arange(1 << k) >> (k - 1 - j)) & 1) << plan.tbits.index(n - 1 - q)
    rebuilt = np.zeros_like(mat)
    phase = np.ones(1 << k) if plan.phase is None else plan.phase
    for i in range(1 << k):
        j = int(np.flatnonzero(local == plan.src[local[i]])[0])
        rebuilt[i, j] = phase[local[i]]
    assert np.array_equal(rebuilt, mat)
    ctrl = op.control_indices if isinstance(op, ControlOp) else ()
    assert plan.cbits == tuple(sorted(n - 1 - q for q in ctrl))


def _old_route(n, op, re, im):
    """The route a monomial op took before the pass: ``_dense_ri`` of its
    matrix, and for a controlled op wider than ``DENSE_CAP`` the inner op
    then a select against the input."""
    if isinstance(op, DenseOp):
        return real_apply._dense_ri(n, op.indices, op.data, re, im)
    if op.num_indices <= DENSE_CAP:
        return real_apply._dense_ri(n, op.indices, op_to_dense(op), re, im)
    _, R, C = geometry(n)
    ir, ii = real_apply._dense_ri(n, op.inner.indices, op_to_dense(op.inner), re, im)
    mask = _control_mask_2d(n, op.control_indices, R, C, re.device)
    return torch.where(mask, ir, re), torch.where(mask, ii, im)


#: (n, targets, controls, phases, dtype): lanes alone, rows alone, both,
#: Shor's layout (wider than ``DENSE_CAP`` with its control).
EXACT_CASES = [
    (12, (6, 11, 8), (), True, torch.float32),
    (12, (1, 3, 0), (4,), False, torch.float64),
    (10, (2, 8, 0, 9), (5, 1), True, torch.float32),
    (12, tuple(range(2, 12)), (0,), False, torch.float32),
    (12, tuple(range(2, 12)), (1,), True, torch.float64),
    (11, (3, 10, 4, 6, 9), (0, 1, 2), True, torch.float64),
    (9, (8, 7), (3, 5, 0), False, torch.float32),
]


@pytest.mark.parametrize("case", range(len(EXACT_CASES)))
def test_plain_pass_equals_the_route_it_replaces(case):
    """Max abs 0 against ``_dense_ri`` (and the select), through
    ``apply_op_ri`` in place (the planes updated, and returned) and on
    copies (the input left as it was)."""
    n, targets, controls, phases, dtype = EXACT_CASES[case]
    rng = np.random.default_rng(case)
    inner = DenseOp(targets, _monomial_matrix(rng, len(targets), phases))
    op = make_control_op(list(controls), inner) if controls else inner
    _, R, C = geometry(n)
    re = torch.tensor(rng.standard_normal((R, C)), dtype=dtype)
    im = torch.tensor(rng.standard_normal((R, C)), dtype=dtype)
    keep = (re.clone(), im.clone())
    wr, wi = _old_route(n, op, re, im)
    fr, fi = real_apply.apply_op_ri(n, op, re, im)
    assert torch.equal(re, keep[0]) and torch.equal(im, keep[1])
    ir, ii = real_apply.apply_op_ri(n, op, re, im, inplace=True)
    assert ir.data_ptr() == re.data_ptr()
    for got in ((fr, fi), (ir, ii)):
        assert (got[0] - wr).abs().max().item() == 0
        assert (got[1] - wi).abs().max().item() == 0


def _emulate(n, plan, xr, xi):
    """numpy: the kernel's work, tile by tile, read from its tables (the
    flat offset of a tile index by two lookups, its segment-local index by
    two more, the source's tile index, the phases in float32)."""
    fr, fi = xr.reshape(-1).copy(), xi.reshape(-1).copy()
    bits, tmask, outer = plan.tile()
    w = plan._table_words().view(np.uint32)
    lo, hi = 1 << monomial.LO_BITS, 1 << (monomial.MAX_TARGETS - monomial.LO_BITS)
    head = 2 * lo + 2 * hi
    off_lo, off_hi = w[:lo].astype(np.int64), w[lo:lo + hi].astype(np.int64)
    sl_lo = w[lo + hi:2 * lo + hi].astype(np.int64)
    sl_hi = w[2 * lo + hi:head].astype(np.int64)
    S = 1 << plan.k
    src = w[head:head + S].astype(np.int64)
    e = np.arange(1 << len(bits))
    off = off_lo[e & (lo - 1)] + off_hi[e >> monomial.LO_BITS]
    s = sl_lo[e & (lo - 1)] | sl_hi[e >> monomial.LO_BITS]
    j = (e & ~tmask) | src[s]
    for tile in range(1 << len(outer)):
        base = plan.cval | sum(((tile >> b) & 1) << ob for b, ob in enumerate(outer))
        a, b = fr[base + off][j], fi[base + off][j]
        if plan.phase is not None:
            ph = w[head + S:head + 3 * S].view(np.float32).reshape(2, S)
            c, d = ph[0][s], ph[1][s]
            a, b = a * c - b * d, a * d + b * c
        fr[base + off], fi[base + off] = a, b
    return fr, fi


@pytest.mark.parametrize("n, targets, controls", [
    (12, tuple(range(2, 12)), (0,)),   # Shor's layout: the lanes and the low row bits
    (13, (3, 0, 7), (12, 11)),         # rows alone, controls on lane bits 0 and 1
    (14, tuple(range(2, 14)), (1, 0)),  # twelve targets: the tile is one segment
])
def test_the_kernel_tables_emulated(n, targets, controls):
    """The kernel's tables, walked in numpy as the kernel walks them, give
    the plain pass bit for bit (float32, with phases); whether a tile takes
    16-byte units is whether flat bits 0 and 1 are tile bits."""
    rng = np.random.default_rng(n)
    op = make_control_op(list(controls), DenseOp(targets, _monomial_matrix(rng, len(targets))))
    plan = monomial.plan_of(n, op)
    _, R, C = geometry(n)
    xr = rng.standard_normal((R, C)).astype(np.float32)
    xi = rng.standard_normal((R, C)).astype(np.float32)
    er, ei = _emulate(n, plan, xr, xi)
    pr, pi = monomial.monomial_pass(n, plan, torch.tensor(xr), torch.tensor(xi), kernel=False)
    assert np.array_equal(er, pr.reshape(-1).numpy())
    assert np.array_equal(ei, pi.reshape(-1).numpy())
    bits = plan.tile()[0]
    assert (bits[:2] == [0, 1]) is (n - 1 not in controls and n - 2 not in controls)
    assert len(bits) == min(max(len(targets), monomial.TILE_BITS), n - len(controls))


def test_counts_bytes_and_span():
    """One count a pass and its least bytes (the touched amplitudes, read
    and written on both planes) on the CPU too; the pass's span sits in
    its op's."""
    n = 10
    rng = np.random.default_rng(1)
    op = make_control_op([0, 3], DenseOp((9, 8, 7), _monomial_matrix(rng, 3)))
    _, R, C = geometry(n)
    re, im = torch.zeros((R, C)), torch.zeros((R, C))
    before = dict(observe.COUNTS)
    with torch.autograd.profiler.profile(use_kineto=False) as prof:
        real_apply.apply_op_ri(n, op, re, im)
    assert observe.COUNTS["monomial_pass"] - before.get("monomial_pass", 0) == 1
    assert observe.COUNTS["monomial_bytes"] - before.get("monomial_bytes", 0) == \
        (1 << (n - 2)) * 2 * 4 * 2
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.function_events if e.name.startswith("rq."))
    (a, b), = [(s, e) for s, e, name in spans if name == "rq.op.control"]
    assert [name for s, e, name in spans if a < s and e <= b] == ["rq.op.monomial"]


def test_shor13_matches_jax():
    """Shor's order-finding circuit with 10 work qubits (N = 1007, a = 2,
    t = 3, n = 13): each controlled multiplication (1 + 10 indices, wider
    than ``DENSE_CAP``) takes the monomial pass; the state within 1e-6 of
    the JAX package's in float32."""
    b = LocalBuilder(dtype="f32", device="cpu")
    shor_period_circuit(b, 2, 1007, t=3)
    before = observe.COUNTS["monomial_pass"]
    got, _ = b.calculate_state(seed=0)
    assert observe.COUNTS["monomial_pass"] - before == 3
    jb = JBuilder()
    j_shor(jb, 2, 1007, t=3)
    want, _ = jb.calculate_state(seed=0)
    assert np.abs(np.asarray(got) - np.asarray(want)).max() <= 1e-6


def _on_the_h100(monkeypatch):
    monkeypatch.setattr(port_compile, "for_device", lambda device: HOPPER)


def _op_sweeps(cc):
    return [p for seg in cc.sweeps if not isinstance(seg, MeasureEntry)
            for kind, p, _ in seg if kind == "op"]


def _config(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("config, circuit, params", [
    ("qft32", qft_circuit, {}),
    ("qpe28", qpe_circuit, {"phase_int": (1 << 26) + 12345}),
    ("qv28", qv_circuit, {"circuit_seed": 2**31 + 1}),
], ids=["qft32", "qpe28", "qv28"])
def test_the_other_cells_plan_no_monomial_pass(monkeypatch, config, circuit, params):
    """Host only: every single-op sweep of the benchmark's other
    configurations, planned with the H100's admission, keeps its route."""
    _on_the_h100(monkeypatch)
    b = LocalBuilder(dtype="f32", device="cpu", kernel_ok=True)
    circuit.build(b, _config(config), params)
    assert all(monomial.plan_of(b.n, op) is None for op in _op_sweeps(b.compile()))


def test_shor31_plans_21_monomial_passes(monkeypatch):
    """Host only: Shor-31 (a = 2, N = 1007, t = 21) with the H100's
    admission: 6 kernel windows (the H layer, the work register's X), the
    21 controlled multiplications as monomial passes (1 control and the
    10 work qubits, the lanes and the 3 lowest row bits), the inverse
    QFT's 5-qubit dense head, 6 kernel windows, the 21-qubit measurement,
    and the reversal's deferred swap of 10 row pairs."""
    _on_the_h100(monkeypatch)
    b = LocalBuilder(dtype="f32", device="cpu", kernel_ok=True)
    shor_period_circuit(b, 2, 1007, t=21)
    cc = b.compile()
    kinds = []
    for seg in cc.sweeps:
        if isinstance(seg, MeasureEntry):
            kinds.append(f"measure{len(seg.indices)}")
            continue
        for kind, p, _ in seg:
            if kind != "op":
                kinds.append(kind)
            elif monomial.plan_of(31, p) is not None:
                kinds.append("monomial")
                plan = monomial.plan_of(31, p)
                assert plan.tbits == tuple(range(10)) and len(plan.cbits) == 1
                assert plan.phase is None and plan.tile()[0][:2] == [0, 1]
            else:
                kinds.append(type(p).__name__)
    assert kinds == (["kwindow"] * 6 + ["monomial"] * 21 + ["kwindow", "DenseOp"]
                     + ["kwindow"] * 5 + ["measure21", "SwapOp"])
