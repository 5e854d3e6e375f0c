"""Quantum volume model circuits through the port's main path
(``LocalBuilder.apply_matrix`` -> ``compile()`` -> ``CompiledCircuit.run``)
against the benchmark's plain reference (``portbench/reference/qv.py``, a
gate-by-gate complex128 state vector): at n = 8, 10 and 14 from |0...0>,
float32 with the kernel windows planned (the CPU runs them through their
plain versions; n = 14 plans some) within 1e-5 and float64 within 1e-10,
in units of 2^-n/2. The plain strip windows and the runs are counted
(``observe.COUNTS``), and so are the register-path windows on a thin
trailing row segment, under the H100's admission on the CPU. A host-only
plan of QV-28 with the H100's admission holds kernel and plain windows:
every window on one of the three row qubits just above the 128 lanes has
a trailing row segment under the 8 rows a Hopper tile needs, so it takes
the register path if its steps are strip-local and stays plain, with an
rmix step, if not; QFT-32's and QPE-28's plans hold no such window. A
dense gate on two row and two lane qubits plans, on the host, as the one
tile-path rmix of 16 matrices that ``test_torch_gpu_tile.py`` holds to
float32 precision on the card."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.circuits import qft as qft_circuit  # noqa: E402
from portbench.circuits import qpe as qpe_circuit  # noqa: E402
from portbench.circuits import qv as qv_circuit  # noqa: E402
from portbench.reference import qv  # noqa: E402
from rustqip_tpu_torch.engine import compile as port_compile  # noqa: E402
from rustqip_tpu_torch.engine.admission import HOPPER, thin_segment, window_seg_sizes  # noqa: E402
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


def _on_the_h100(monkeypatch):
    """Plan the CPU builders' circuits with the H100's admission."""
    monkeypatch.setattr(port_compile, "for_device", lambda device: HOPPER)
    monkeypatch.setattr(port_compile, "_CACHE", {})


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


def test_thin_register_windows_are_counted(monkeypatch):
    """QV-12 planned with the H100's admission on the CPU: its register
    windows on a thin trailing row segment run through their plain
    versions, each counted once a run in ``COUNTS["window_stream_thin"]``
    (the plan also holds a register window that is not thin, and tile
    windows, neither counted), and the state stays within 1e-5 of the
    reference. (QV-10 plans at most one kernel window: every window there
    covers the whole row space.)"""
    _on_the_h100(monkeypatch)
    n, seed = 12, 2**31 + 12
    cfg = _cfg(n, pairs_seed=3)
    cc = _compiled(cfg, "f32", seed)
    kernel = [p for kind, p, _ in _sweeps(cc) if kind == "kwindow"]
    thin = sum(1 for seg, _, prog in kernel if thin_segment(seg))
    assert thin == sum(1 for seg, _, prog in kernel
                       if thin_segment(seg) and prog.path == "registers")
    assert thin > 0
    assert any(prog.path == "registers" and not thin_segment(seg) for seg, _, prog in kernel)
    assert any(prog.path == "tile" for _, _, prog in kernel)
    before = observe.COUNTS["window_stream_thin"]
    for _ in range(2):
        re, im, _ = cc.run(0)
    assert observe.COUNTS["window_stream_thin"] - before == 2 * thin
    got = re.double().reshape(-1).numpy() + 1j * im.double().reshape(-1).numpy()
    want = qv.state(n, qv.circuit(cfg, {"circuit_seed": seed})).numpy()
    assert np.abs(got - want).max() * 2.0 ** (n / 2) <= TOL["f32"]


#: QV-28's plan with the H100's admission, by pairs seed (1 is the
#: benchmark configuration's): sweeps, kernel windows, register windows,
#: register windows on a thin trailing row segment, plain windows.
QV28_PLANS = {1: (216, 203, 106, 62, 13), 2: (219, 195, 107, 49, 24)}


@pytest.mark.parametrize("pairs_seed", [1, 2])
def test_qv28_plan_on_the_h100(monkeypatch, pairs_seed):
    """Host only, no state: QV-28 planned with the H100's admission. Every
    window that holds a row qubit n - 10 .. n - 8 has a trailing row
    segment of 1, 2 or 4 rows, under ``HOPPER.MIN_TILE_ROWS``: the kernel
    takes it on the register path where its steps are strip-local, and
    it stays a plain window where they are not (every plain window holds
    an rmix step, and is refused for that reason alone)."""
    _on_the_h100(monkeypatch)
    n = 28
    cc = _compiled(_cfg(n, pairs_seed), "f32", 2**31 + pairs_seed)
    counts = cc.sweep_counts()
    sweeps = _sweeps(cc)
    kernel = [p for kind, p, _ in sweeps if kind == "kwindow"]
    plain = [p for kind, p, _ in sweeps if kind == "window"]
    thin = [prog for seg, _, prog in kernel if thin_segment(seg)]
    assert all(prog.path == "registers" for prog in thin)
    assert (len(sweeps), counts["kwindow"],
            sum(1 for _, _, prog in kernel if prog.path == "registers"),
            len(thin), counts["window"]) == QV28_PLANS[pairs_seed]
    assert counts["op"] == 0
    assert not any(prog.mag_rounded for _, _, prog in kernel)
    for hq, steps in plain:
        assert set(hq) & {n - 10, n - 9, n - 8}, hq
        assert HOPPER.block_rows(len(hq), steps, window_seg_sizes(n, hq)[-1]) \
            < HOPPER.MIN_TILE_ROWS
        assert any(s[0] == "rmix" for s in steps), steps


@pytest.mark.parametrize("config, circuit, params, kernel, ops, rounded", [
    ("qft32", qft_circuit, {}, 7, 1, 0),
    ("qpe28", qpe_circuit, {"phase_int": (1 << 26) + 12345}, 11, 2, 1),
], ids=["qft32", "qpe28"])
def test_qft32_and_qpe28_plan_no_thin_window(monkeypatch, config, circuit, params, kernel,
                                             ops, rounded):
    """Host only: the other two configurations of the benchmark, planned
    with the H100's admission, hold no window on a thin trailing row
    segment, so their plans are what they were before the register path
    took such windows: every sweep a kernel window or a single op. QPE-28's
    phase product, whose log-magnitude rounds to 1 in float32, is a kernel
    window of its own (``WindowProgram.mag_rounded``); QFT-32's controlled
    phases are unit-modulus and need no such rule."""
    _on_the_h100(monkeypatch)
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{config}.json").read_text())
    b = LocalBuilder(dtype="f32", device="cpu", kernel_ok=True)
    circuit.build(b, cfg, params)
    cc = b.compile()
    assert cc.sweep_counts() == {"kwindow": kernel, "window": 0, "op": ops}
    assert sum(p[2].mag_rounded for kind, p, _ in _sweeps(cc) if kind == "kwindow") == rounded
    for kind, payload, _ in _sweeps(cc):
        if kind == "kwindow":
            seg, _, prog = payload
            assert not thin_segment(seg) and prog.bt >= HOPPER.MIN_TILE_ROWS


def test_dense_row_lane_gate_is_one_rmix_of_16_matrices(monkeypatch):
    """Host only: the window of ``test_torch_gpu_tile``'s precision test
    (QV's dense gates make such rmix steps) with the H100's admission."""
    _on_the_h100(monkeypatch)
    b = LocalBuilder(dtype="f32", device="cpu", kernel_ok=True)
    rmix16_circuit(b, 20)
    ((kind, (_, _, prog), _),) = _sweeps(b.compile())
    assert kind == "kwindow" and prog.path == "tile" and prog.kinds == ("rmix",)
    assert prog.h == 2 and prog.nchunks == 16 * 8
