"""The comparison that decides ``correct`` fails what it must.

The control (the reference computed in TF32 in the program's place) fails
a limit of every cell on three seeds, at a size a test run holds. Each
fault that these cells can have, planted under a whole run on the CPU
(``run_cell`` past the look for a card, at 14 qubits, where the CPU
plans kernel windows), makes ``correct`` false: the
window kernel returning its state unchanged, every sweep returning its
state unchanged, and the answer altered where the program produces it.
(No cell has a batch whose half could be left out, or an exchange
between chips.)"""

import pytest

from _small import CPU, FAULT, SMALL
from portbench import harness, limits
from rustqip_tpu_torch.engine import compile as port_compile
from rustqip_tpu_torch.engine import real_apply


@pytest.mark.parametrize("seed", [11, 2**31 + 5, 3_000_000_019])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_fails_a_limit(name, seed):
    checks, correct = limits.control_numbers(name, seed, 8, "cpu", SMALL[name])
    assert not correct
    assert any(c["value"] > 3 * c["limit"] for c in checks.values()), checks


def _window_unchanged(monkeypatch, name):
    monkeypatch.setattr(real_apply.window_kernel, "window_sweep",
                        lambda n, re, im, *a, **k: (re, im))


def _sweeps_unchanged(monkeypatch, name):
    monkeypatch.setattr(port_compile, "run_sweeps", lambda n, sweeps, re, im, **k: (re, im))


def _answer_altered(monkeypatch, name):
    if FAULT[name].get("counting_qubits"):
        draw = port_compile.sample_outcome
        monkeypatch.setattr(port_compile, "sample_outcome",
                            lambda probs, gen: (draw(probs, gen) + 1) % probs.numel())
    else:
        sweeps = port_compile.run_sweeps

        def altered(n, s, re, im, **k):
            re, im = sweeps(n, s, re, im, **k)
            return re * (1 + 1e-3), im

        monkeypatch.setattr(port_compile, "run_sweeps", altered)


@pytest.mark.parametrize("fault", [_window_unchanged, _sweeps_unchanged, _answer_altered],
                         ids=["window_unchanged", "sweeps_unchanged", "answer_altered"])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_planted_fault_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch, name)
    r = harness.run_cell(name, 2**31 + 99, 0.3, False, cfg_overrides=FAULT[name], **CPU)
    assert r["failed"] == 0
    assert not r["correct"], r["checks"]
