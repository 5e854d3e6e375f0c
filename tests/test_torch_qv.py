"""Quantum volume model circuits through the port's main path
(``LocalBuilder.apply_matrix`` -> ``compile()`` -> ``CompiledCircuit.run``)
against the benchmark's plain reference (``portbench/reference/qv.py``, a
gate-by-gate complex128 state vector): at n = 8, 10 and 14 from |0...0>,
float32 with the kernel windows planned (the CPU runs them through their
plain versions; n = 14 plans some) within 1e-5 and float64 within 1e-10,
in units of 2^-n/2. The plain strip windows and the runs are counted
(``observe.COUNTS``). A host-only plan of QV-28 with the H100's admission
holds kernel and plain windows, and every plain window touches one of
the three row qubits just above the 128 lanes: its trailing row segment
is under the 8 rows a Hopper tile needs. A dense gate on two row and two
lane qubits plans, on the host, as the one tile-path rmix of 16 matrices
that ``test_torch_gpu_tile.py`` holds to float32 precision on the card."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.circuits import qv as qv_circuit  # noqa: E402
from portbench.reference import qv  # noqa: E402
from rustqip_tpu_torch.engine import compile as port_compile  # noqa: E402
from rustqip_tpu_torch.engine.admission import HOPPER, window_seg_sizes  # noqa: E402
from rustqip_tpu_torch.engine.compile import MeasureEntry  # noqa: E402
from rustqip_tpu_torch.prelude import LocalBuilder  # noqa: E402
from rustqip_tpu_torch.utils import observe  # noqa: E402
from test_torch_gpu_tile import rmix16_circuit  # noqa: E402

torch.set_num_threads(1)  # the test runner keeps one worker per core busy

TOL = {"f32": 1e-5, "f64": 1e-10}


def _cfg(n, pairs_seed=1):
    return {"num_qubits": n, "depth": n, "pairs_seed": pairs_seed}


def _compiled(cfg, dtype, seed):
    b = LocalBuilder(dtype=dtype, device="cpu", kernel_ok=True)
    qv_circuit.build(b, cfg, {"circuit_seed": seed})
    return b.compile()


def _sweeps(cc):
    return [s for seg in cc.sweeps if not isinstance(seg, MeasureEntry) for s in seg]


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("n, seed", [(8, 3), (10, 2**31 + 7), (14, 3_000_000_019)])
def test_qv_matches_the_reference(n, seed, dtype):
    cfg = _cfg(n, pairs_seed=seed + 1)
    cc = _compiled(cfg, dtype, seed)
    re, im, _ = cc.run(0)
    got = re.double().reshape(-1).numpy() + 1j * im.double().reshape(-1).numpy()
    want = qv.state(n, qv.circuit(cfg, {"circuit_seed": seed})).numpy()
    assert np.abs(got - want).max() * 2.0 ** (n / 2) <= TOL[dtype]
    if dtype == "f32" and n == 14:
        assert cc.sweep_counts()["kwindow"] > 0 and cc.sweep_counts()["window"] > 0


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_plain_windows_and_runs_are_counted(dtype):
    n = 10
    cc = _compiled(_cfg(n), dtype, 5)
    strips = sum(1 for kind, p, _ in _sweeps(cc) if kind == "window" and p[0])
    assert strips > 0
    before = dict(observe.COUNTS)
    for _ in range(3):
        cc.run(0)
    delta = {k: observe.COUNTS[k] - before.get(k, 0)
             for k in ("window_plain", "window_plain_bytes", "circuit_runs")}
    itemsize = 4 if dtype == "f32" else 8
    assert observe.pass_bytes(n, itemsize) == (1 << n) * 2 * itemsize * 2
    assert delta == {"window_plain": 3 * strips,
                     "window_plain_bytes": 3 * strips * observe.pass_bytes(n, itemsize),
                     "circuit_runs": 3}


@pytest.mark.parametrize("pairs_seed", [1, 2])
def test_qv28_plan_on_the_h100(monkeypatch, pairs_seed):
    """Host only, no state: QV-28 planned with the H100's admission takes
    both kernel and plain windows, and every plain window is refused for
    one reason: it holds a row qubit n - 10 .. n - 8, so its trailing row
    segment is 1, 2 or 4 rows, under ``HOPPER.MIN_TILE_ROWS``. Pairs seed 1
    is the benchmark configuration's."""
    monkeypatch.setattr(port_compile, "for_device", lambda device: HOPPER)
    monkeypatch.setattr(port_compile, "_CACHE", {})
    n = 28
    cc = _compiled(_cfg(n, pairs_seed), "f32", 2**31 + pairs_seed)
    counts = cc.sweep_counts()
    assert counts["kwindow"] > 0 and counts["window"] > 0 and counts["op"] == 0
    plain = [p for kind, p, _ in _sweeps(cc) if kind == "window"]
    assert len(plain) == counts["window"]
    for hq, steps in plain:
        assert set(hq) & {n - 10, n - 9, n - 8}, hq
        assert HOPPER.block_rows(len(hq), steps, window_seg_sizes(n, hq)[-1]) \
            < HOPPER.MIN_TILE_ROWS


def test_dense_row_lane_gate_is_one_rmix_of_16_matrices(monkeypatch):
    """Host only: the window of ``test_torch_gpu_tile``'s precision test
    (QV's dense gates make such rmix steps) with the H100's admission."""
    monkeypatch.setattr(port_compile, "for_device", lambda device: HOPPER)
    monkeypatch.setattr(port_compile, "_CACHE", {})
    b = LocalBuilder(dtype="f32", device="cpu", kernel_ok=True)
    rmix16_circuit(b, 20)
    ((kind, (_, _, prog), _),) = _sweeps(b.compile())
    assert kind == "kwindow" and prog.path == "tile" and prog.kinds == ("rmix",)
    assert prog.h == 2 and prog.nchunks == 16 * 8
