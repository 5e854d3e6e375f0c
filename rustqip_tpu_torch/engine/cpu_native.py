"""ctypes bindings to the native C++ CPU engine (``csrc/qip_engine.cpp``).

Port of ``rustqip_tpu/engine/cpu_native.py``, over the port's op IR. The
native engine is (a) an oracle independent of the torch engine and (b) the
same-machine CPU baseline a benchmark divides by (the algorithmic stand-in
for the reference's Rust engine).

The source is the port's own copy, ``rustqip_tpu_torch/csrc/qip_engine.cpp``.
At first use it is compiled by a host C++ compiler (``$CXX``, then every
``g++``, ``c++`` and ``clang++`` on the ``PATH``, in order) with
``CXX_FLAGS`` into ``build/rustqip_tpu_torch/`` (listed in .gitignore),
named by a hash of the source, the flags and the host: the library is
built with ``-march=native``, so a build made on one machine is never
loaded on another. No compiler, or no compiler that builds it with these
flags, raises with each compiler's error.

Ops that are not dense are densified (``op_to_dense``) up to
``DENSIFY_MAX_QUBITS`` qubits and refused above it; the JAX package
densifies a ``ReflectionOp`` of any width.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from typing import Optional, Sequence

import numpy as np

from rustqip_tpu_torch.engine.cuda_build import BUILD_DIR, CSRC
from rustqip_tpu_torch.ops.matrix_ops import (
    ControlOp,
    DenseOp,
    MatrixOp,
    ReflectionOp,
    SparseOp,
    SwapOp,
    op_to_dense,
)

#: The flags of the JAX package's ``csrc/Makefile``.
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-fPIC", "-shared", "-std=c++17")
#: Widest op densified for the engine: a 2^12 x 2^12 complex128 matrix is
#: 256 MiB.
DENSIFY_MAX_QUBITS = 12
_lib: Optional[ctypes.CDLL] = None


def compilers() -> list:
    """The host C++ compilers to try, in order, or raises."""
    found = []
    names = [os.environ.get("CXX")] + [
        os.path.join(d, name) for name in ("g++", "c++", "clang++")
        for d in os.get_exec_path()
    ]
    for cand in names:
        path = cand and shutil.which(cand)
        if path and os.path.realpath(path) not in map(os.path.realpath, found):
            found.append(path)
    if not found:
        raise RuntimeError(
            "native engine: no C++ compiler found ($CXX, g++, c++ or clang++); "
            "it builds rustqip_tpu_torch/csrc/qip_engine.cpp at first use"
        )
    return found


def _host_key() -> bytes:
    """What ``-march=native`` depends on: the machine and its CPU flags."""
    cpu = ""
    try:
        with open("/proc/cpuinfo") as f:
            cpu = "".join(
                line for line in f if line.startswith(("model name", "flags"))
            )
    except OSError:
        pass
    return f"{platform.node()}|{platform.machine()}|{cpu}".encode()


def library_path() -> str:
    """Where the engine builds to, for the current source, flags and host."""
    src = (CSRC / "qip_engine.cpp").read_bytes()
    tag = hashlib.sha256(src + " ".join(CXX_FLAGS).encode() + _host_key()).hexdigest()[:16]
    return str(BUILD_DIR / f"libqip_engine_{tag}.so")


def build() -> str:
    """Compile the engine unless it is built already; returns its path.
    Every compiler is tried in turn with ``CXX_FLAGS``."""
    out = library_path()
    if os.path.exists(out):
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    errors = []
    for cc in compilers():
        cmd = [cc, *CXX_FLAGS, "-o", tmp, str(CSRC / "qip_engine.cpp")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode == 0:
            os.replace(tmp, out)
            return out
        errors.append(f"{' '.join(cmd)} ({res.returncode}):\n{res.stderr.strip()}")
    raise RuntimeError("native engine: every build failed:\n" + "\n".join(errors))


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the native engine, or raise."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    i32p = ctypes.POINTER(ctypes.c_int32)
    for suffix, fp in (("f64", ctypes.c_double), ("f32", ctypes.c_float)):
        fpp = ctypes.POINTER(fp)
        getattr(lib, f"qip_apply_dense_{suffix}").argtypes = [
            ctypes.c_int, i32p, ctypes.c_int, fpp, fpp, fpp,
        ]
        getattr(lib, f"qip_apply_control_dense_{suffix}").argtypes = [
            ctypes.c_int, i32p, ctypes.c_int, i32p, ctypes.c_int, fpp, fpp, fpp,
        ]
        getattr(lib, f"qip_apply_swap_{suffix}").argtypes = [
            ctypes.c_int, i32p, i32p, ctypes.c_int, fpp, fpp,
        ]
        getattr(lib, f"qip_prob_magnitude_{suffix}").argtypes = [ctypes.c_int, fpp]
        getattr(lib, f"qip_prob_magnitude_{suffix}").restype = ctypes.c_double
        getattr(lib, f"qip_measure_prob_{suffix}").argtypes = [
            ctypes.c_int, ctypes.c_uint64, i32p, ctypes.c_int, fpp,
        ]
        getattr(lib, f"qip_measure_prob_{suffix}").restype = ctypes.c_double
        getattr(lib, f"qip_measure_state_{suffix}").argtypes = [
            ctypes.c_int, ctypes.c_uint64, ctypes.c_double, i32p, ctypes.c_int,
            fpp, fpp,
        ]
        for name in ("apply_dense", "apply_control_dense", "apply_swap", "measure_state"):
            getattr(lib, f"qip_{name}_{suffix}").restype = None
    lib.qip_num_threads.argtypes = []
    lib.qip_num_threads.restype = ctypes.c_int
    _lib = lib
    return _lib


def native_threads() -> int:
    """Threads the engine's OpenMP loops run on."""
    return load_library().qip_num_threads()


def _suffix_and_real(dtype) -> tuple:
    dtype = np.dtype(dtype)
    if dtype == np.complex64:
        return "f32", np.float32, ctypes.c_float
    if dtype == np.complex128:
        return "f64", np.float64, ctypes.c_double
    raise ValueError(f"Unsupported dtype {dtype}")


def _as_pairs(arr: np.ndarray, real_dtype) -> np.ndarray:
    """Complex array viewed as interleaved (re, im) pairs."""
    return np.ascontiguousarray(arr).view(real_dtype)


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _i32(seq: Sequence[int]) -> np.ndarray:
    return np.asarray(seq, dtype=np.int32)


def _dense(op: MatrixOp, dtype) -> np.ndarray:
    """The op's own matrix in ``dtype``; refused above
    ``DENSIFY_MAX_QUBITS`` qubits unless the op is dense already."""
    if not isinstance(op, DenseOp) and op.num_indices > DENSIFY_MAX_QUBITS:
        raise ValueError(
            f"native engine: will not densify a {op.num_indices}-qubit "
            f"{type(op).__name__} (cap {DENSIFY_MAX_QUBITS} qubits)"
        )
    return np.ascontiguousarray(op_to_dense(op).astype(dtype))


def native_apply_op(n: int, op: MatrixOp, state: np.ndarray) -> np.ndarray:
    """Apply one gate op through the native engine; returns a new state
    array (complex64 or complex128, as ``state``)."""
    lib = load_library()
    suffix, real, ctype = _suffix_and_real(state.dtype)
    out = np.empty_like(state)
    in_pairs = _as_pairs(state, real)
    out_pairs = out.view(real)
    if isinstance(op, (DenseOp, SparseOp, ReflectionOp)):
        mat = _dense(op, state.dtype)
        idx = _i32(op.indices)
        getattr(lib, f"qip_apply_dense_{suffix}")(
            n, _ptr(idx, ctypes.c_int32), len(op.indices),
            _ptr(_as_pairs(mat, real), ctype),
            _ptr(in_pairs, ctype), _ptr(out_pairs, ctype),
        )
    elif isinstance(op, SwapOp):
        h = op.half
        a, b = _i32(op.indices[:h]), _i32(op.indices[h:])
        getattr(lib, f"qip_apply_swap_{suffix}")(
            n, _ptr(a, ctypes.c_int32), _ptr(b, ctypes.c_int32), h,
            _ptr(in_pairs, ctype), _ptr(out_pairs, ctype),
        )
    elif isinstance(op, ControlOp):
        inner = op.inner
        mat = _dense(inner, state.dtype)
        cidx = _i32(op.control_indices)
        tidx = _i32(inner.indices)
        getattr(lib, f"qip_apply_control_dense_{suffix}")(
            n, _ptr(cidx, ctypes.c_int32), op.n_ctrl,
            _ptr(tidx, ctypes.c_int32), inner.num_indices,
            _ptr(_as_pairs(mat, real), ctype),
            _ptr(in_pairs, ctype), _ptr(out_pairs, ctype),
        )
    else:
        raise TypeError(f"Unknown op {op!r}")
    return out


def native_measure_prob(
    n: int, measured: int, indices: Sequence[int], state: np.ndarray
) -> float:
    lib = load_library()
    suffix, real, ctype = _suffix_and_real(state.dtype)
    idx = _i32(indices)
    return getattr(lib, f"qip_measure_prob_{suffix}")(
        n, measured, _ptr(idx, ctypes.c_int32), len(idx),
        _ptr(_as_pairs(state, real), ctype),
    )


def native_prob_magnitude(n: int, state: np.ndarray) -> float:
    lib = load_library()
    suffix, real, ctype = _suffix_and_real(state.dtype)
    return getattr(lib, f"qip_prob_magnitude_{suffix}")(
        n, _ptr(_as_pairs(state, real), ctype)
    )


def native_measure_state(
    n: int,
    measured: int,
    prob: float,
    indices: Sequence[int],
    state: np.ndarray,
) -> np.ndarray:
    lib = load_library()
    suffix, real, ctype = _suffix_and_real(state.dtype)
    out = np.empty_like(state)
    idx = _i32(indices)
    getattr(lib, f"qip_measure_state_{suffix}")(
        n, measured, prob, _ptr(idx, ctypes.c_int32), len(idx),
        _ptr(_as_pairs(state, real), ctype), _ptr(out.view(real), ctype),
    )
    return out
