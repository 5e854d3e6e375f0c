"""Measurement on flat complex states and on (re, im) planes.

Port of ``rustqip_tpu/ops/measurement_ops.py`` (re-design of
``qip/src/state_ops/measurement_ops.rs``): ``prob_magnitude``,
``measure_probs``, ``measure_state`` and ``measure`` take a flat complex
state, the ``*_ri`` functions its planes. A state given as a tensor is
measured on its own device, one given as a numpy array on ``device`` (the
card unless the caller passes ``"cpu"``), as in ``engine.apply_op``.
Probabilities
always take the planned (R, C) path (``_probs_plan``), one row block of
``types.PASS_BLOCK`` elements at a time: a 0/1 column matmul, then one sum
over the block's unmeasured row-bit runs. The JAX package's off-TPU
rank-n reshape would need n axes, past torch's 25-dim limit for CUDA
reductions at n = 28. A collapse works in place by row block
(``_collapse_``): the public functions copy their input first, and
``CompiledCircuit.run`` collapses the planes it owns, so at n = 32 no
pass holds a second plane-sized tensor.

Sampling takes an explicit ``torch.Generator`` (a CPU generator: the
outcome distribution, or for more than 2^24 outcomes its block sums and one
block, is copied to the host to sample from). Torch cannot reproduce
``jax.random`` draws, so parity with the JAX package goes through forced
outcomes (``MeasuredCondition``) and outcome distributions.

``measure_prob_fn`` sums |f|^2 of an amplitude *function* over a subspace,
in three tiers: chunks of int32 index tensors on ``device`` (the card by
default), numpy chunks on the host, scalar calls.

Conventions (identical to the reference, measurement_ops.rs:21-22): bit
``i`` of a measured outcome is the value of qubit ``indices[i]``.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from rustqip_tpu_torch import types as _types
from rustqip_tpu_torch.errors import CircuitError
from rustqip_tpu_torch.types import fresh_plane, geometry, state_tensor
from rustqip_tpu_torch.utils.bits import move_bits


@dataclass
class MeasuredCondition:
    """Force a specific measurement outcome (ref measurement_ops.rs:181)."""

    measured: int
    prob: Optional[float] = None


@lru_cache(maxsize=256)
def _probs_plan(n: int, indices: Tuple[int, ...]):
    """Host-side plan: the column-reduction matrix, the weights that build
    the final outcome-order permutation (``_outcome_perm``), and the
    measured row and lane qubit counts. The row reduction is per block
    (``_block_plan``)."""
    m, R, C = geometry(n)
    k = len(indices)
    srt = sorted(indices)
    h = sum(1 for q in srt if q < n - m)
    low = [q for q in srt if q >= n - m]
    l = len(low)
    cols = np.arange(C)
    pattern = np.zeros(C, dtype=np.int64)
    for t, q in enumerate(low):
        bit = (cols >> (n - 1 - q)) & 1
        pattern |= bit << (l - 1 - t)
    M_c = np.zeros((C, 1 << l), dtype=np.float64)
    M_c[cols, pattern] = 1.0
    weights = tuple(1 << (k - 1 - srt.index(q)) for q in indices)
    return M_c, weights, h, l, R, C


def _outcome_perm(weights: Tuple[int, ...], device) -> torch.Tensor:
    """Outcome m has bit t = the value of indices[t]: its entry in the
    reduced probabilities, built by doubling on ``device`` (outcomes
    [2^t, 2^(t+1)) are [0, 2^t) plus bit t's weight), so no 2^k index
    array crosses from the host (2 GiB at k = 28)."""
    perm = torch.zeros(1, dtype=torch.int64, device=device)
    for w in weights:
        perm = torch.cat([perm, perm + w])
    return perm


def _check_indices(n: int, indices) -> Tuple[int, ...]:
    indices = tuple(int(i) for i in indices)
    if len(set(indices)) != len(indices):
        raise CircuitError("Measurement indices must be unique")
    return indices


def prob_magnitude(state, device="cuda") -> torch.Tensor:
    """Total |psi|^2 of a flat complex state (ref measurement_ops.rs:11)."""
    x = torch.view_as_real(state_tensor(state, device))
    return (x * x).sum()


@lru_cache(maxsize=256)
def _block_plan(n: int, indices: Tuple[int, ...], rows: int):
    """How one block of ``rows`` rows (a power of two, aligned) reduces:
    the view of its lane-reduced squares that exposes each run of its row
    bits as one axis (then the 2^l measured-lane outcomes), the axes of the
    runs that are not measured (summed away), and the measured row qubits
    above the block, whose bits in the block's index say where its
    2^(h_in + l) partial sums go."""
    n_m = n - geometry(n)[0]
    b = rows.bit_length() - 1
    measured = set(indices)
    l = sum(1 for q in indices if q >= n_m)
    runs: list = []  # [bit-run length, measured?], most significant first
    for q in range(n_m - b, n_m):
        if runs and runs[-1][1] == (q in measured):
            runs[-1][0] += 1
        else:
            runs.append([1, q in measured])
    shape = tuple(1 << L for L, _ in runs) + (1 << l,)
    axes = tuple(i for i, (_, mem) in enumerate(runs) if not mem)
    above = tuple(q for q in sorted(indices) if q < n_m - b)
    return shape, axes, above


def _probs_blocked(n: int, indices: Tuple[int, ...], re: torch.Tensor,
                   im: torch.Tensor) -> torch.Tensor:
    """Outcome distribution of the (R, C) planes ``re``, ``im`` (real
    planes, or the real and imaginary views of one complex plane), in
    row blocks of ``PASS_BLOCK`` elements: each block is squared, reduced
    over the lanes by the 0/1 matrix ``M_c`` and over its unmeasured row
    bits, and added into the outcomes its measured row bits above the
    block select. Scratch is one block whatever n and k are; the result
    equals the whole-state reduction up to the order of summation."""
    M_c, weights, h, l, R, C = _probs_plan(n, indices)
    rows = min(R, max(1, _types.PASS_BLOCK // C))
    shape, axes, above = _block_plan(n, indices, rows)
    n_m, b = R.bit_length() - 1, rows.bit_length() - 1
    mc = torch.as_tensor(M_c, dtype=re.dtype, device=re.device)
    acc = torch.zeros((1 << len(above), 1 << (h - len(above) + l)),
                      dtype=re.dtype, device=re.device)
    for r0 in range(0, R, rows):
        blk = r0 >> b
        out = 0
        for q in above:
            out = (out << 1) | ((blk >> (n_m - b - 1 - q)) & 1)
        xr, xi = re[r0:r0 + rows], im[r0:r0 + rows]
        sq = xr * xr + xi * xi
        red = (sq @ mc).reshape(shape)
        if axes:
            red = red.sum(dim=axes)
        acc[out] += red.reshape(-1)
    flat = acc.reshape(-1)
    return flat[_outcome_perm(weights, flat.device)]


def measure_probs(n: int, indices: Sequence[int], state, device="cuda") -> torch.Tensor:
    """Probability of every outcome of measuring ``indices`` on a flat
    complex state (ref measurement_ops.rs:115): shape (2^k,), entry m =
    P(qubit indices[i] == bit i of m)."""
    _, R, C = geometry(n)
    x = state_tensor(state, device).reshape(R, C)
    return _probs_blocked(n, _check_indices(n, indices), x.real, x.imag)


def measure_probs_ri(
    n: int, indices: Sequence[int], re: torch.Tensor, im: torch.Tensor
) -> torch.Tensor:
    """``measure_probs`` on (re, im) planes."""
    _, R, C = geometry(n)
    return _probs_blocked(n, _check_indices(n, indices), re.reshape(R, C),
                          im.reshape(R, C))


def measure_prob(
    n: int, measured: int, indices: Sequence[int], re: torch.Tensor,
    im: torch.Tensor,
) -> torch.Tensor:
    """Probability of one specific outcome (ref measurement_ops.rs:44)."""
    return measure_probs_ri(n, indices, re, im)[measured]


#: Elements per tier-1 chunk of ``measure_prob_fn`` (a power of two):
#: 2^22 int32 indices and f's temporaries stay tens of MiB at any n.
DEVICE_CHUNK = 1 << 22
#: Which tier answered each ``measure_prob_fn`` call: "device",
#: "vectorized" or "scalar".
TIER_CALLS: Counter = Counter()
# (fn serial, n, remaining, chunk, device) of each f that passed tier 1's
# probe: warm queries skip the probe.
_DEVICE_PROBED: dict = {}


def _subspace_runs(n: int, remaining: Sequence[int]):
    """``(counter_bit, state_bit, length)`` runs (for ``move_bits``) that
    spread a subspace counter onto the state bits of the ``remaining``
    qubits, in ascending order of state bit: a larger counter is a larger
    index."""
    runs = []
    for j, b in enumerate(sorted(n - 1 - q for q in remaining)):
        if runs and runs[-1][0] + runs[-1][2] == j and runs[-1][1] + runs[-1][2] == b:
            runs[-1][2] += 1
        else:
            runs.append([j, b, 1])
    return tuple(tuple(r) for r in runs)


def _complex_numpy(v) -> np.ndarray:
    v = torch.as_tensor(v).detach().cpu()
    return v.numpy().astype(np.complex128)


def _measure_prob_fn_device(n: int, template: int, remaining: tuple, f, device):
    """Tier 1: |f|^2 summed over the subspace in (rows, 128) chunks of int32
    index tensors on ``device``, accumulated there in float64 (one host read
    at the end). None when ``f`` fails the probe: the largest and smallest
    subspace indices, the same batch reversed (an ``f`` that depends on
    batch position), and scalar calls with exact Python ints as ground
    truth (an ``f`` whose int32 arithmetic overflows at the largest
    indices). The first chunk of an ``f`` not probed before is part of the
    probe (an ``f`` that breaks on 2-D tiles); after it, a failure raises.
    int32 index math caps it at n <= 31."""
    r = len(remaining)
    if n > 31 or r < 1:
        return None
    from rustqip_tpu_torch.ops.matrix_ops import _auto_tag_serial

    dev = torch.device(device)
    runs = _subspace_runs(n, remaining)
    size = 1 << r
    key = (_auto_tag_serial(f), n, remaining, DEVICE_CHUNK, str(dev))
    first = key not in _DEVICE_PROBED
    if first:
        lo = np.arange(min(4, size), dtype=np.int64)
        hi = np.arange(max(size - 4, 0), size, dtype=np.int64)
        probe = template | move_bits(np.unique(np.concatenate([lo, hi])), runs)
        # made before the probe: a device that is not there raises
        fwd = torch.as_tensor(probe, dtype=torch.int32, device=dev)
        rev = torch.as_tensor(probe[::-1].copy(), dtype=torch.int32, device=dev)
        try:
            got = _complex_numpy(f(fwd))
            if got.shape != probe.shape:
                return None
            if not np.allclose(got, _complex_numpy(f(rev))[::-1], rtol=1e-4, atol=1e-9):
                return None
            try:
                want = np.array([complex(f(int(j))) for j in probe])
            except Exception:
                want = None  # an f for tensors only: no scalar ground truth
            if want is not None and not np.allclose(got, want, rtol=1e-4, atol=1e-9):
                return None
        except Exception:
            return None
    chunk = min(size, DEVICE_CHUNK)
    rows, cols = max(chunk // 128, 1), min(chunk, 128)
    base = template | move_bits(
        torch.arange(chunk, dtype=torch.int32, device=dev).reshape(rows, cols), runs
    )
    acc = torch.zeros((), dtype=torch.float64, device=dev)
    for c in range(size // chunk):
        idx = base | move_bits(c * chunk, runs)
        try:
            v = torch.as_tensor(f(idx), device=dev)
            if v.shape != idx.shape:
                raise ValueError(f"f returned shape {tuple(v.shape)} for index "
                                 f"shape {tuple(idx.shape)}")
        except Exception:
            if first and c == 0:
                return None
            raise
        sq = v.real * v.real + v.imag * v.imag if v.is_complex() else v * v
        acc = acc + sq.sum(dtype=torch.float64)
    _DEVICE_PROBED[key] = True
    return float(acc)


def measure_prob_fn(
    n: int, measured: int, indices: Sequence[int], f, device="cuda"
) -> float:
    """Outcome probability from an amplitude *function* ``f(index) ->
    complex`` rather than a stored vector (ref ``measure_prob_fn``,
    measurement_ops.rs:65-112): sums |f|^2 over the subspace matching
    ``measured``.

    Three evaluation tiers, best first (``TIER_CALLS`` counts which one
    answered):

    1. an ``f`` elementwise over int32 torch tensors (checked by a probe):
       chunks of ``DEVICE_CHUNK`` indices on ``device`` — the card unless
       the caller passes ``"cpu"`` — summed there;
    2. a numpy-elementwise ``f``: 2^20-entry host chunks;
    3. a scalar-only ``f``: per-index Python calls (the reference's lazy
       stream, Python-bound).
    """
    indices = _check_indices(n, indices)
    template = 0
    for i, q in enumerate(indices):
        if (measured >> i) & 1:
            template |= 1 << (n - 1 - q)
    remaining = tuple(q for q in range(n) if q not in indices)
    r = len(remaining)

    res = _measure_prob_fn_device(n, template, remaining, f, device)
    if res is not None:
        TIER_CALLS["device"] += 1
        return res

    runs = _subspace_runs(n, remaining)
    probe = template | move_bits(np.arange(min(2, 1 << r), dtype=np.int64), runs)
    vectorized = False
    try:
        got = np.asarray(f(probe), dtype=np.complex128)
        want = np.array([complex(f(int(j))) for j in probe])
        vectorized = got.shape == probe.shape and np.allclose(got, want)
    except Exception:
        pass

    total = 0.0
    chunk = 1 << 20
    for start in range(0, 1 << r, chunk):
        stop = min(start + chunk, 1 << r)
        idx = template | move_bits(np.arange(start, stop, dtype=np.int64), runs)
        if vectorized:
            amps = np.asarray(f(idx), dtype=np.complex128)
        else:
            amps = np.array([complex(f(int(j))) for j in idx], dtype=np.complex128)
        total += float(np.sum(amps.real**2 + amps.imag**2))
    TIER_CALLS["vectorized" if vectorized else "scalar"] += 1
    return total


def soft_measure(
    n: int, indices: Sequence[int], re: torch.Tensor, im: torch.Tensor,
    generator: torch.Generator,
) -> int:
    """Sample an outcome without collapsing (ref measurement_ops.rs:153):
    one draw from the reduced outcome distribution with an explicit
    generator (the reference walks an inverse CDF over raw amplitudes
    against a global RNG; the distribution is the same)."""
    return sample_outcome(measure_probs_ri(n, indices, re, im), generator)


def _collapse_(n: int, indices: Sequence[int], measured: Tuple[int, float], planes):
    """Collapse (R, C) planes (real planes, or one complex plane) IN PLACE
    to ``measured = (outcome, prob)``, by row block of ``PASS_BLOCK``
    elements: a block whose measured row bits above it miss the outcome is
    zeroed whole; inside a block the amplitudes are scaled by
    1/sqrt(prob), then the lanes and rows that miss are filled with 0.
    No (R, C) mask is built. ``prob == 0`` leaves them as they are (the
    reference's guard, measurement_ops.rs:230). Returns ``planes``."""
    m, R, C = geometry(n)
    n_m = n - m
    scale = _collapse_scale(measured[1], planes[0].real.dtype)
    if scale is None:
        return planes
    rmask = rwant = cmask = cwant = 0
    for t, q in enumerate(int(i) for i in indices):
        bit = (int(measured[0]) >> t) & 1
        if q < n_m:
            rmask, rwant = rmask | 1 << (n_m - 1 - q), rwant | bit << (n_m - 1 - q)
        else:
            cmask, cwant = cmask | 1 << (n - 1 - q), cwant | bit << (n - 1 - q)
    dev = planes[0].device
    rows = min(R, max(1, _types.PASS_BLOCK // C))
    low, high = rmask & (rows - 1), rmask & ~(rows - 1)
    lane_off = (torch.arange(C, device=dev) & cmask) != cwant if cmask else None
    row_off = ((torch.arange(rows, device=dev) & low) != (rwant & low))[:, None] if low else None
    for r0 in range(0, R, rows):
        for x in planes:
            blk = x[r0:r0 + rows]
            if r0 & high != rwant & high:
                blk.zero_()
                continue
            blk.mul_(scale)
            if lane_off is not None:
                blk.masked_fill_(lane_off, 0)
            if row_off is not None:
                blk.masked_fill_(row_off, 0)
    return planes


def measure_state_ri(
    n: int,
    indices: Sequence[int],
    measured: Tuple[int, float],
    re: torch.Tensor,
    im: torch.Tensor,
):
    """Collapse: zero non-matching amplitudes, scale by 1/sqrt(p)
    (ref measurement_ops.rs:220); ``prob == 0`` leaves the state as is
    (the reference's guard, :230). Returns fresh planes: the input is
    copied, then collapsed in place (``_collapse_``)."""
    _, R, C = geometry(n)
    planes = [fresh_plane(re, R, C), fresh_plane(im, R, C)]
    return tuple(_collapse_(n, indices, measured, planes))


def _collapse_scale(prob, real_dtype: torch.dtype) -> Optional[float]:
    """1/sqrt(prob) in ``real_dtype``, or None for ``prob == 0`` (the
    reference's guard: the state stays as it is)."""
    prob = float(prob)
    if not prob > 0:
        return None
    np_dtype = np.float32 if real_dtype == torch.float32 else np.float64
    tiny = float(torch.finfo(real_dtype).tiny)
    return float(1.0 / np.sqrt(max(np.asarray(prob, dtype=np_dtype), tiny)))


def measure_state(
    n: int, indices: Sequence[int], measured: Tuple[int, float], state, device="cuda",
) -> torch.Tensor:
    """Collapse a flat complex state (ref measurement_ops.rs:220):
    ``measured`` is ``(outcome, prob)``; amplitudes that do not match the
    outcome become 0, the others are scaled by 1/sqrt(prob), and
    ``prob == 0`` leaves the state as it is (:230). Returns a new flat
    state."""
    _, R, C = geometry(n)
    x = fresh_plane(state_tensor(state, device), R, C)
    return _collapse_(n, indices, measured, [x])[0].reshape(-1)


#: Most outcomes drawn in one stage: a larger distribution is not copied to
#: the host whole.
ONE_STAGE_MAX = 1 << 16


def sample_outcome(probs: torch.Tensor, generator: torch.Generator) -> int:
    """Draw one outcome index from a (2^k,) distribution with a CPU
    ``generator``. Up to ``ONE_STAGE_MAX`` outcomes the host draws from the
    whole distribution in float64. Above it the draw is exact in two
    stages, on every device alike: a block from the block sums (reduced in
    float64 where ``probs`` lives), then an outcome within that block
    (2^ceil(k/2) outcomes a block), so the host reads two vectors of about
    2^(k/2) entries and a seed gives the same outcome on the CPU and the
    card."""
    p = probs.detach().reshape(-1)
    if p.numel() <= ONE_STAGE_MAX:
        p = p.to("cpu", torch.float64).clamp_min(0)
        return int(torch.multinomial(p, 1, generator=generator).item())
    k = p.numel().bit_length() - 1
    width = 1 << ((k + 1) // 2)
    blocks = p.reshape(-1, width)
    b = sample_outcome(blocks.sum(dim=1, dtype=torch.float64), generator)
    return b * width + sample_outcome(blocks[b], generator)



def _draw(probs: torch.Tensor, generator, measured: Optional[MeasuredCondition]):
    """(outcome, prob) of one measurement: forced by ``measured`` (its prob,
    or the outcome's own when it gives none), else drawn with
    ``generator`` by ``sample_outcome``."""
    if measured is not None:
        outcome = int(measured.measured)
        prob = measured.prob if measured.prob is not None else float(probs[outcome])
        return outcome, float(prob)
    if generator is None:
        raise CircuitError("measure() needs a generator unless the outcome is forced")
    outcome = sample_outcome(probs, generator)
    return outcome, float(probs[outcome])


def measure(
    n: int,
    indices: Sequence[int],
    state,
    generator: Optional[torch.Generator] = None,
    measured: Optional[MeasuredCondition] = None,
    device="cuda",
):
    """Sample and collapse a flat complex state (ref
    measurement_ops.rs:190): returns ``(outcome, prob, collapsed state)``.
    ``measured`` forces the outcome (the ``MeasuredCondition`` path);
    otherwise ``generator`` (a CPU ``torch.Generator``, the JAX package's
    PRNG key) is required."""
    x = state_tensor(state, device)
    outcome, prob = _draw(measure_probs(n, indices, x), generator, measured)
    return outcome, prob, measure_state(n, indices, (outcome, prob), x)


def measure_ri(
    n: int,
    indices: Sequence[int],
    re: torch.Tensor,
    im: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    measured: Optional[MeasuredCondition] = None,
):
    """``measure`` on (re, im) planes: returns ``(outcome, prob, re, im)``."""
    outcome, prob = _draw(measure_probs_ri(n, indices, re, im), generator, measured)
    re, im = measure_state_ri(n, indices, (outcome, prob), re, im)
    return outcome, prob, re, im
