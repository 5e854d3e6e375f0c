"""Measurement in the port against the JAX package: ``measure_prob``,
``measure_prob_fn`` in each of its three tiers (the probe's fallbacks
included), and ``soft_measure`` by its distribution (the two packages'
draws differ: torch cannot reproduce ``jax.random``). Tier 1 runs here on
the CPU (``device="cpu"``); on the card it is the same code. Tolerance:
1e-12 in f64 (both sum the same squares).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rustqip_tpu.ops import measurement_ops as RM  # noqa: E402

from rustqip_tpu_torch.interop import planes_from_numpy  # noqa: E402
from rustqip_tpu_torch.ops import measurement_ops as M  # noqa: E402

torch.set_num_threads(1)  # the test runner keeps one worker per core busy


def _state(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return v / np.linalg.norm(v)


def test_measure_prob_matches_reference():
    n = 9
    v = _state(n, 5)
    re, im = planes_from_numpy(v, dtype=torch.float64)
    for indices in ([0], [2, 4], [8, 1, 3], [7, 8]):
        for m in range(1 << len(indices)):
            got = float(M.measure_prob(n, m, indices, re, im))
            want = float(RM.measure_prob(n, m, indices, jnp.asarray(v)))
            assert abs(got - want) <= 1e-12


def _fn_forms(amps):
    """One amplitude vector as three functions: elementwise over torch
    tensors (tier 1), over numpy arrays only (tier 2), scalar only (tier
    3)."""
    tab = torch.as_tensor(amps)

    def torch_f(i):
        return tab[torch.as_tensor(i).long()]

    def numpy_f(i):
        if isinstance(i, torch.Tensor):
            raise TypeError("numpy only")
        return amps[np.asarray(i)]

    def scalar_f(i):
        if not isinstance(i, int):
            raise TypeError("scalar only")
        return complex(amps[i])

    return {"device": torch_f, "vectorized": numpy_f, "scalar": scalar_f}


@pytest.mark.parametrize("tier", ["device", "vectorized", "scalar"])
def test_measure_prob_fn_tiers_match_reference(tier):
    """Each tier answers, and agrees with measure_prob on the stored state
    and with the JAX package's measure_prob_fn on the same function."""
    n = 8
    amps = _state(n, 6)
    f = _fn_forms(amps)[tier]
    re, im = planes_from_numpy(amps, dtype=torch.float64)
    ref_f = _fn_forms(amps)["scalar" if tier == "scalar" else "vectorized"]
    for indices in ([0], [3, 7], [7, 2, 5]):
        for m in range(1 << len(indices)):
            before = M.TIER_CALLS[tier]
            got = M.measure_prob_fn(n, m, indices, f, device="cpu")
            assert M.TIER_CALLS[tier] == before + 1
            assert abs(got - float(M.measure_prob(n, m, indices, re, im))) <= 1e-12
            assert abs(got - RM.measure_prob_fn(n, m, indices, ref_f)) <= 1e-12


def test_measure_prob_fn_device_tier_chunks_and_probe_cache(monkeypatch):
    """Several (rows, 128) chunks sum exactly (support points in the first
    and the last chunk), and warm queries of the same f skip the probe."""
    monkeypatch.setattr(M, "DEVICE_CHUNK", 1 << 9)
    n = 12

    def f(i):
        zero = torch.zeros(i.shape, dtype=torch.float64)
        return torch.where(i == 5, 0.6, torch.where(i == (1 << n) - 3, 0.8, zero))

    before = len(M._DEVICE_PROBED)
    p0 = M.measure_prob_fn(n, 0, [0], f, device="cpu")
    p1 = M.measure_prob_fn(n, 1, [0], f, device="cpu")
    assert abs(p0 - 0.36) <= 1e-12 and abs(p1 - 0.64) <= 1e-12
    assert len(M._DEVICE_PROBED) == before + 1
    ref = RM.measure_prob_fn(n, 1, [0], lambda i: jnp.where(
        jnp.asarray(i) == 5, 0.6, jnp.where(jnp.asarray(i) == (1 << n) - 3, 0.8, 0.0)))
    assert abs(p1 - ref) <= 1e-12


def test_measure_prob_fn_rank_sensitive_fn_falls_back():
    """An f that passes the 1-D probe but breaks the (rows, 128) tiles
    falls back to the host tiers with the right answer."""
    n = 8

    def f(i):
        i = torch.as_tensor(i)
        v = torch.where(i < 32, 1.0 / np.sqrt(32), torch.zeros(i.shape, dtype=torch.float64))
        return v.reshape(-1)  # flattens the device tier's 2-D tile

    before = M.TIER_CALLS["device"]
    p0 = M.measure_prob_fn(n, 0, [0], f, device="cpu")
    p1 = M.measure_prob_fn(n, 1, [0], f, device="cpu")
    assert M.TIER_CALLS["device"] == before
    assert abs(p0 - 1.0) <= 1e-12 and abs(p1) <= 1e-12


def test_measure_prob_fn_int32_fragile_fn_falls_back():
    """Tier 1 feeds f int32 indices; an f whose i*i overflows there fails
    the probe at the largest subspace indices (scalar calls are exact), so
    the int64 host tiers answer — as in the JAX package."""
    n = 20

    def f(i):
        i = torch.as_tensor(i)
        return torch.where(i * i < (1 << 28), 1.0, 0.5)

    def jf(i):
        i = jnp.asarray(i)
        return jnp.where(i * i < (1 << 28), 1.0, 0.5)

    before = M.TIER_CALLS["device"]
    got = M.measure_prob_fn(n, 0, [n - 1], f, device="cpu")
    assert M.TIER_CALLS["device"] == before
    idx = np.arange(0, 1 << n, 2, dtype=np.int64)
    want = float(np.sum(np.where(idx * idx < (1 << 28), 1.0, 0.5) ** 2))
    assert abs(got - want) <= 1e-12 * want
    assert abs(got - RM.measure_prob_fn(n, 0, [n - 1], jf)) <= 1e-12 * want


@pytest.mark.parametrize("split", [False, True], ids=["multinomial", "two_stage"])
def test_soft_measure_distribution(monkeypatch, split):
    """soft_measure draws from the same outcome distribution as the JAX
    package's (its measure_probs); 8000 draws agree with it within 5
    sigma per outcome, with one multinomial draw and with the two-stage
    draw used above 2^16 outcomes."""
    if split:
        monkeypatch.setattr(M, "ONE_STAGE_MAX", 4)
    n = 5
    v = _state(n, 12)
    indices = [4, 0, 2]
    probs = np.asarray(RM.measure_probs(n, indices, jnp.asarray(v)))
    re, im = planes_from_numpy(v, dtype=torch.float64)
    np.testing.assert_allclose(M.measure_probs_ri(n, indices, re, im).numpy(), probs,
                               atol=1e-12)
    gen = torch.Generator().manual_seed(3)
    draws = 8000
    counts = np.bincount(
        [M.soft_measure(n, indices, re, im, gen) for _ in range(draws)], minlength=8)
    sigma = np.sqrt(draws * probs * (1 - probs))
    assert np.all(np.abs(counts - draws * probs) <= 5 * sigma + 1)


def test_measure_prob_fn_device_tier_raises_without_the_device():
    """Tier 1 on a device that is not there raises; it does not quietly
    take the host tiers."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        M.measure_prob_fn(4, 0, [0], lambda i: torch.ones(i.shape) / 4, device="cuda")


def _sparse_distribution(k, support, seed):
    """A (2^k,) float64 distribution on ``support`` outcomes spread over
    the blocks of the two-stage draw (some share a block), with dyadic
    weights: exact in float32 and float64 alike."""
    rng = np.random.default_rng(seed)
    outcomes = np.unique(np.concatenate([
        rng.choice(1 << k, size=support - 8, replace=False),
        (rng.integers(0, 1 << k) & ~0xFF) + np.arange(8)]))
    weights = rng.integers(16, 64, size=outcomes.size).astype(np.float64)
    p = np.zeros(1 << k)
    p[outcomes] = weights
    total = 1 << int(np.ceil(np.log2(weights.sum())))
    p[outcomes[0]] += total - weights.sum()  # dyadic total: p sums to 1 exactly
    return torch.as_tensor(p / total), outcomes


def test_two_stage_draw_above_2_16_holds_chi_square():
    """2^17 outcomes take the two-stage draw; 1000 draws from a 16-point
    distribution (every expected count above 15) land only on its support
    and pass a chi-square test at the 1e-4 level."""
    from scipy.stats import chi2

    k = 17
    assert (1 << k) > M.ONE_STAGE_MAX
    probs, support = _sparse_distribution(k, 16, seed=9)
    gen = torch.Generator().manual_seed(17)
    draws = 1000
    counts = np.bincount([M.sample_outcome(probs, gen) for _ in range(draws)],
                         minlength=1 << k)
    assert counts.sum() == counts[support].sum() == draws
    want = draws * probs.numpy()[support]
    stat = float(((counts[support] - want) ** 2 / want).sum())
    assert stat < chi2.ppf(1 - 1e-4, support.size - 1)


def test_two_stage_draw_is_one_rule_for_a_seed():
    """A seed gives the same outcomes whatever the distribution's dtype
    (the host reads float64 block sums and one block either way), and they
    are the block-then-offset draw written out by hand: 2^9 block sums of
    2^9 outcomes each at k = 18."""
    k = 18
    probs, _ = _sparse_distribution(k, 24, seed=4)
    width = 1 << ((k + 1) // 2)
    blocks = probs.reshape(-1, width)
    g_hand = torch.Generator().manual_seed(5)
    want = []
    for _ in range(32):
        b = int(torch.multinomial(blocks.sum(dim=1), 1, generator=g_hand))
        want.append(b * width + int(torch.multinomial(blocks[b], 1, generator=g_hand)))
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator().manual_seed(5)
        got = [M.sample_outcome(probs.to(dtype), gen) for _ in range(32)]
        assert got == want
