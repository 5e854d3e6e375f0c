"""The op algebra's transpose and inverse in the port against the JAX
package's, on every constructor's op (the identity and conjugate cases, and
the harness, are in ``test_torch_ops.py``): exact, both are the same numpy
arithmetic."""

import pytest

pytest.importorskip("jax")

import torch  # noqa: E402
from test_torch_ops import _pairs, check_op_to_dense  # noqa: E402

torch.set_num_threads(1)  # the test runner keeps one worker per core busy


@pytest.mark.parametrize("name,ref,port", _pairs(), ids=[p[0] for p in _pairs()])
@pytest.mark.parametrize("algebra", ["transpose", "invert"])
def test_op_to_dense_matches_reference(name, ref, port, algebra):
    check_op_to_dense(ref, port, algebra)
