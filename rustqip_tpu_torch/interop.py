"""Carry ops and states between the JAX package and the port.

Duck-typed on attribute and class names, so nothing here imports JAX or
``rustqip_tpu``: the port's tests build a circuit once with the JAX
package's constructors and feed both packages the same ops and the same
seeded numpy states. A function op's ``fn`` crosses as is.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from rustqip_tpu_torch.ops.matrix_ops import (
    ControlOp,
    DenseOp,
    FnOp,
    MatrixOp,
    PhaseProductOp,
    ReflectionOp,
    SparseOp,
    SwapOp,
)
from rustqip_tpu_torch.types import split_state


def op_from_reference(op) -> MatrixOp:
    """The port's op equal to one JAX-package op."""
    kind = type(op).__name__
    if kind == "DenseOp":
        data = np.array(op.data, dtype=np.complex128)
        data.setflags(write=False)
        return DenseOp(tuple(int(q) for q in op.indices), data)
    if kind == "SparseOp":
        rows = tuple(
            tuple((int(c), complex(v)) for c, v in row) for row in op.rows
        )
        return SparseOp(tuple(int(q) for q in op.indices), rows)
    if kind == "SwapOp":
        return SwapOp(tuple(int(q) for q in op.indices))
    if kind == "ControlOp":
        return ControlOp(
            int(op.n_ctrl),
            tuple(int(q) for q in op.indices),
            op_from_reference(op.inner),
        )
    if kind == "PhaseProductOp":
        return PhaseProductOp(
            tuple(
                (tuple(int(q) for q in idx), tuple(complex(v) for v in d))
                for idx, d in op.terms
            )
        )
    if kind == "ReflectionOp":
        return ReflectionOp(tuple(int(q) for q in op.indices))
    if kind == "FnOp":
        # the fn is carried as is: it must compute with operators that
        # int32 torch tensors and the JAX package's arrays both take
        return FnOp(
            tuple(int(q) for q in op.indices), op.fn, str(op.tag),
            bool(op.conjugated), bool(op.self_transpose), bool(op.diagonal),
        )
    raise TypeError(f"Unknown op {op!r}")


def ops_from_reference(ops: Sequence) -> list:
    return [op_from_reference(op) for op in ops]


def planes_from_numpy(
    state: np.ndarray, dtype=torch.float32, device="cuda"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A flat complex 2^n state -> (R, C) (re, im) planes of ``dtype`` on
    ``device`` (the card unless the caller passes ``"cpu"``): the state
    API's split (``types.split_state``), then the cast."""
    state = np.asarray(state).reshape(-1)
    re, im = split_state(state.size.bit_length() - 1, state, device)
    return re.to(dtype), im.to(dtype)


def planes_to_numpy(re: torch.Tensor, im: torch.Tensor) -> np.ndarray:
    """(re, im) planes -> a flat complex128 numpy state."""
    r = re.detach().cpu().numpy().astype(np.float64).reshape(-1)
    i = im.detach().cpu().numpy().astype(np.float64).reshape(-1)
    return r + 1j * i
