"""The port's native C++ CPU engine (``engine/cpu_native.py``, built from
``rustqip_tpu_torch/csrc/qip_engine.cpp`` into ``build/``) against the JAX
package's native engine and against the port's torch engine, at n = 10:
1e-10 in complex128, 1e-5 in complex64. Also the densify guard the JAX
package lacks, and a clear error without a compiler.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from rustqip_tpu.engine import cpu_native as JN  # noqa: E402
from rustqip_tpu.ops import matrix_ops as JM  # noqa: E402

from rustqip_tpu_torch.engine import cpu_native as PN  # noqa: E402
from rustqip_tpu_torch.engine.real_apply import apply_op_ri  # noqa: E402
from rustqip_tpu_torch.interop import planes_from_numpy, planes_to_numpy  # noqa: E402
from rustqip_tpu_torch.ops import gates  # noqa: E402
from rustqip_tpu_torch.ops import matrix_ops as PM  # noqa: E402

torch.set_num_threads(1)  # the test runner keeps one worker per core busy

N = 10


def random_state(n, dtype=np.complex128, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return (v / np.linalg.norm(v)).astype(dtype)


def random_unitary(rng, dim):
    m = rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))
    return np.linalg.qr(m)[0]


def _ops(M):
    """The JAX file's ops, plus a reflection and a sparse permutation, built
    with either package's constructors (``M``: its ``matrix_ops``)."""
    rng = np.random.default_rng(11)
    u4a, u4b = random_unitary(rng, 4), random_unitary(rng, 4)
    perm = np.random.default_rng(5).permutation(8)
    return {
        "h": M.make_matrix_op([0], gates.H.reshape(-1)),
        "t": M.make_matrix_op([3], gates.T.reshape(-1)),
        "dense2": M.make_matrix_op([1, 8], u4a.reshape(-1)),
        "swap": M.make_swap_op([0, 1], [7, 9]),
        "cx": M.make_control_op([2], M.make_matrix_op([5], gates.X.reshape(-1))),
        "ccu": M.make_control_op([0, 9], M.make_matrix_op([2, 3], u4b.reshape(-1))),
        "reflection": M.make_reflection_op([1, 4, 6, 8]),
        "sparse3": M.make_sparse_matrix_op([2, 7, 4], [[(int(perm[i]), 1j ** i)] for i in range(8)]),
    }


PORT_OPS = _ops(PM)
JAX_OPS = _ops(JM)


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64], ids=["c128", "c64"])
@pytest.mark.parametrize("name", sorted(PORT_OPS))
def test_native_matches_jax_native_and_torch(name, dtype):
    psi = random_state(N, dtype, seed=len(name))
    got = PN.native_apply_op(N, PORT_OPS[name], psi)
    assert got.dtype == dtype
    atol = 1e-10 if dtype == np.complex128 else 1e-5
    np.testing.assert_allclose(got, JN.native_apply_op(N, JAX_OPS[name], psi), atol=atol)
    rdt = torch.float64 if dtype == np.complex128 else torch.float32
    want = planes_to_numpy(*apply_op_ri(N, PORT_OPS[name], *planes_from_numpy(psi, dtype=rdt, device="cpu")))
    np.testing.assert_allclose(got, want, atol=atol)


def test_native_measurement_and_collapse_match_jax():
    n = 8
    psi = random_state(n, seed=3)
    for indices in ([0], [2, 4], [7, 0, 1]):
        for m in range(1 << len(indices)):
            a = PN.native_measure_prob(n, m, indices, psi)
            assert abs(a - JN.native_measure_prob(n, m, indices, psi)) < 1e-12
    assert abs(PN.native_prob_magnitude(n, psi) - 1.0) < 1e-10
    p = PN.native_measure_prob(n, 0b10, [1, 3], psi)
    np.testing.assert_allclose(PN.native_measure_state(n, 0b10, p, [1, 3], psi),
                               JN.native_measure_state(n, 0b10, p, [1, 3], psi),
                               atol=1e-12)


def test_native_refuses_to_densify_a_wide_reflection():
    """The JAX package densifies a ReflectionOp of any width (a 2^k x 2^k
    matrix); the port refuses above ``DENSIFY_MAX_QUBITS``."""
    k = PN.DENSIFY_MAX_QUBITS + 1
    psi = np.zeros(1 << k, dtype=np.complex64)
    with pytest.raises(ValueError, match="will not densify"):
        PN.native_apply_op(k, PM.make_reflection_op(range(k)), psi)


def test_native_build_without_a_compiler_raises(monkeypatch):
    """The library path is keyed by the host, and a missing compiler is an
    error that names the source, not a silent ``None``."""
    assert PN.library_path().startswith(str(PN.BUILD_DIR))
    assert PN.native_threads() >= 1
    monkeypatch.setenv("CXX", "no-such-compiler")
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="qip_engine.cpp"):
        PN.compilers()


def test_native_build_that_fails_everywhere_raises(monkeypatch, tmp_path):
    """A compiler that cannot build with the Makefile's flags is not
    retried with other flags: when none builds, the error names each
    command, ``-fopenmp`` included."""
    monkeypatch.setattr(PN, "library_path", lambda: str(tmp_path / "libqip_engine.so"))
    monkeypatch.setattr(PN, "compilers", lambda: ["false", "false"])
    with pytest.raises(RuntimeError, match="every build failed") as err:
        PN.build()
    assert str(err.value).count("-fopenmp") == 2
    assert not list(tmp_path.iterdir())
