"""Measurement on (re, im) planes.

Port of the plane functions of ``rustqip_tpu/ops/measurement_ops.py``
(re-design of ``qip/src/state_ops/measurement_ops.rs``). Probabilities
always take the planned (R, C) path (``_probs_plan``): one 0/1 column
matmul, then top-down row reductions whose sizes halve each step. The JAX
package's off-TPU rank-n reshape would need n axes, past torch's 25-dim
limit for CUDA reductions at n = 28.

Sampling takes an explicit ``torch.Generator`` (a CPU generator: the
2^k outcome distribution is copied to the host to sample from). Torch
cannot reproduce ``jax.random`` draws, so parity with the JAX package goes
through forced outcomes (``MeasuredCondition``) and stochastic
distributions.

Not ported yet (ROADMAP port queue): ``measure_prob_fn``, ``soft_measure``.

Conventions (identical to the reference, measurement_ops.rs:21-22): bit
``i`` of a measured outcome is the value of qubit ``indices[i]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from rustqip_tpu_torch.errors import CircuitError
from rustqip_tpu_torch.types import MINOR_QUBITS


@dataclass
class MeasuredCondition:
    """Force a specific measurement outcome (ref measurement_ops.rs:181)."""

    measured: int
    prob: Optional[float] = None


def _geometry(n: int) -> Tuple[int, int, int]:
    m = min(n, MINOR_QUBITS)
    return m, 1 << (n - m), 1 << m


@lru_cache(maxsize=256)
def _probs_plan(n: int, indices: Tuple[int, ...]):
    """Host-side plan: column-reduction matrix, row-reduction order, and
    the final outcome-order permutation."""
    m, R, C = _geometry(n)
    k = len(indices)
    srt = sorted(indices)
    high = [q for q in srt if q < n - m]
    low = [q for q in srt if q >= n - m]
    h, l = len(high), len(low)
    cols = np.arange(C)
    pattern = np.zeros(C, dtype=np.int64)
    for t, q in enumerate(low):
        bit = (cols >> (n - 1 - q)) & 1
        pattern |= bit << (l - 1 - t)
    M_c = np.zeros((C, 1 << l), dtype=np.float64)
    M_c[cols, pattern] = 1.0
    non_measured = [q for q in range(n - m) if q not in high]
    remaining = list(range(n - m))
    steps = []
    for q in non_measured:
        ax = remaining.index(q)
        steps.append((1 << ax, 1 << (len(remaining) - ax - 1)))
        remaining.remove(q)
    perm = np.zeros(1 << k, dtype=np.int64)
    for mval in range(1 << k):
        s = 0
        for t, q in enumerate(indices):
            if (mval >> t) & 1:
                s |= 1 << (k - 1 - srt.index(q))
        perm[mval] = s
    return M_c, tuple(steps), perm, h, l, R, C


def _check_indices(n: int, indices) -> Tuple[int, ...]:
    indices = tuple(int(i) for i in indices)
    if len(set(indices)) != len(indices):
        raise CircuitError("Measurement indices must be unique")
    return indices


def measure_probs_ri(
    n: int, indices: Sequence[int], re: torch.Tensor, im: torch.Tensor
) -> torch.Tensor:
    """Probability of every outcome of measuring ``indices``
    (ref measurement_ops.rs:115): shape (2^k,), entry m = P(qubit
    indices[i] == bit i of m)."""
    indices = _check_indices(n, indices)
    M_c, row_steps, perm, h, l, R, C = _probs_plan(n, indices)
    sq = (re * re + im * im).reshape(R, C)
    reduced = sq @ torch.as_tensor(M_c, dtype=sq.dtype, device=sq.device)
    for a, b in row_steps:
        cdim = reduced.shape[-1]
        reduced = reduced.reshape(a, 2, b * cdim).sum(dim=1).reshape(-1, cdim)
    flat = reduced.reshape(-1)
    return flat[torch.as_tensor(perm, device=flat.device)]


def _collapse_mask(n: int, indices: Tuple[int, ...], outcome: int, device):
    """(R, C) bool mask of basis states matching the outcome."""
    m, R, C = _geometry(n)
    n_m = n - m
    rows = torch.arange(R, device=device)
    cols = torch.arange(C, device=device)
    mask_r = torch.ones((R,), dtype=torch.bool, device=device)
    mask_c = torch.ones((C,), dtype=torch.bool, device=device)
    for t, q in enumerate(indices):
        bit = (int(outcome) >> t) & 1
        if q < n_m:
            mask_r = mask_r & (((rows >> (n_m - 1 - q)) & 1) == bit)
        else:
            mask_c = mask_c & (((cols >> (n - 1 - q)) & 1) == bit)
    return mask_r[:, None] & mask_c[None, :]


def measure_state_ri(
    n: int,
    indices: Sequence[int],
    measured: Tuple[int, float],
    re: torch.Tensor,
    im: torch.Tensor,
):
    """Collapse: zero non-matching amplitudes, scale by 1/sqrt(p)
    (ref measurement_ops.rs:220); ``prob == 0`` leaves the state as is
    (the reference's guard, :230)."""
    indices = tuple(int(i) for i in indices)
    outcome, prob = measured
    _, R, C = _geometry(n)
    prob = float(prob)
    if not prob > 0:
        return re.reshape(R, C), im.reshape(R, C)
    tiny = float(torch.finfo(re.dtype).tiny)
    scale = 1.0 / np.sqrt(max(np.asarray(prob, dtype=_np_dtype(re)), tiny))
    mask = _collapse_mask(n, indices, outcome, re.device)
    zero = torch.zeros((), dtype=re.dtype, device=re.device)
    return (
        torch.where(mask, re.reshape(R, C) * float(scale), zero),
        torch.where(mask, im.reshape(R, C) * float(scale), zero),
    )


def _np_dtype(x: torch.Tensor):
    return np.float32 if x.dtype == torch.float32 else np.float64


def sample_outcome(probs: torch.Tensor, generator: torch.Generator) -> int:
    """Draw one outcome index from a (2^k,) distribution."""
    p = probs.detach().to("cpu", torch.float64).clamp_min(0)
    return int(torch.multinomial(p, 1, generator=generator).item())

