"""The plain references: the QFT's DFT against the textbook circuit and an
explicit DFT matrix, QPE's distribution against its closed form, TF32
rounding, and each cell's jobs through the port on the CPU at 10-12 qubits
against the reference (the run's own check)."""

import numpy as np
import pytest
import torch

from _small import CPU, SMALL
from portbench import harness
from portbench.reference import qft, qpe, statevec
from portbench.reference.precision import EXACT, TF32, round_tf32, round_tf32_np


@pytest.mark.parametrize("x", [0, 1, 77, 255])
def test_qft_dft_equals_textbook_circuit(x):
    n = 8
    psi = statevec.qft(statevec.basis(n, x), n, range(n))
    want = qft.amplitudes(n, x, np.arange(1 << n))
    assert np.abs(psi.numpy() - want).max() < 1e-12
    dft = np.exp(2j * np.pi * np.outer(np.arange(1 << n), np.arange(1 << n)) / (1 << n))
    assert np.abs(dft[x] / 16.0 - want).max() < 1e-12


def test_inverse_qft_inverts():
    n = 6
    v = torch.randn(1 << n, dtype=torch.complex128)
    back = statevec.qft(statevec.qft(v.clone(), n, range(n)), n, range(n), inverse=True)
    assert (back - v).abs().max() < 1e-12


def test_qft_amplitudes_at_32_qubits_exact():
    """x k mod 2^32 without overflow: the uint64 wrap keeps the low bits."""
    x, ks = (1 << 32) - 1, np.array([1, 2, (1 << 32) - 1], dtype=np.uint64)
    got = qft.amplitudes(32, x, ks) * 2.0 ** 16
    want = np.exp(2j * np.pi * np.array([(x * int(k)) % (1 << 32) for k in ks]) / 2.0 ** 32)
    assert np.abs(got - want).max() < 1e-15


@pytest.mark.parametrize("j", [1, 3, 1001, 2047])
def test_qpe_reference_peaks_at_the_phase(j):
    cfg = {**SMALL["qpe28.fresh"], "target_qubits": 1}
    ref = qpe.solve(cfg, {"phase_int": j}, 0)
    p = ref["probs"].numpy()
    assert abs(p[j] - 1) < 1e-12 and abs(p.sum() - 1) < 1e-12
    job = type("J", (), {"answer": {"outcome": qpe.flip(11, j), "prob": 1.0}})()
    assert qpe.numbers(cfg, ref, job) == {"outcome_miss": 0.0, "prob_gap": pytest.approx(0, abs=1e-12)}
    job.answer = {"outcome": qpe.flip(11, j ^ 1), "prob": float(ref["probs"][j ^ 1])}
    assert qpe.numbers(cfg, ref, job) == {"outcome_miss": 1.0, "prob_gap": 0.0}


@pytest.mark.parametrize("j", [1, 5, 1001, 2047])
def test_qpe_closed_form_agrees_with_the_circuit(j):
    """The closed form that judges every job (outcome j bit-reversed, at
    probability 1) reads what the gate-by-gate reference reads."""
    cfg = {**SMALL["qpe28.fresh"], "target_qubits": 1}
    ref = qpe.solve(cfg, {"phase_int": j}, 0)
    for y in (j, j ^ 4):
        job = type("J", (), {"params": {"phase_int": j},
                             "answer": {"outcome": qpe.flip(11, y), "prob": 0.999}})()
        closed, full = qpe.closed_numbers(cfg, job), qpe.numbers(cfg, ref, job)
        assert closed["outcome_miss"] == full["outcome_miss"] == float(y != j)
        assert closed["prob_gap"] == pytest.approx(full["prob_gap"], abs=1e-12)


def test_qpe_draws_odd_phases():
    rng = np.random.default_rng(3)
    ks = [qpe.draw_params({"phase_bits": 27}, rng)["phase_int"] for _ in range(200)]
    assert all(k % 2 == 1 and 0 < k < 1 << 27 for k in ks)


def test_tf32_rounding():
    x = np.array([1.0, 1 + 2**-11, 1 + 2**-12, -(1 + 3 * 2**-12), 2**-0.5], dtype=np.float32)
    got = round_tf32_np(x)
    assert got.tolist() == [1.0, 1 + 2**-10, 1.0, -(1 + 2**-10), 0.70703125]
    t = torch.tensor(x)
    assert round_tf32(t).tolist() == got.tolist()
    z = torch.complex(t, -t)
    assert torch.equal(round_tf32(z).imag, -round_tf32(t))
    # no bits below the 10th survive
    assert (round_tf32(torch.randn(1000)).view(torch.int32) & 0x1FFF).eq(0).all()


def test_statevec_convention_matches_the_builder():
    """The reference's big-endian indices, X and the measured value's bit
    order are the port builder's (a 3-qubit circuit through the port)."""
    from rustqip_tpu_torch.prelude import LocalBuilder

    b = LocalBuilder(dtype="f64", device="cpu")
    q0 = b.x(b.qubit())
    r = b.merge_two_registers(q0, b.register(2))
    r, m = b.measure(r)
    state, meas = b.calculate_state(seed=1)
    psi = statevec.x(statevec.basis(3, 0), 3, 0)
    assert np.abs(state - psi.numpy()).max() == 0
    outcome, _ = meas.get_measurement(m)
    assert qpe.flip(3, outcome) == 0b100


@pytest.mark.parametrize("name", sorted(SMALL))
def test_cell_jobs_agree_with_the_reference(name):
    r = harness.run_cell(name, 2**31 + 4242, 0.6, False, cfg_overrides=SMALL[name], **CPU)
    assert r["correct"], r
    assert r["attempted"] >= 2 and r["failed"] == 0
    for c in r["checks"].values():
        assert c["value"] <= c["limit"] / 10
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "card", "checks"]
