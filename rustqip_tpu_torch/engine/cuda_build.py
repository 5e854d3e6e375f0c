"""The one seam between the port and its CUDA kernels: build, load, type,
check, launch and count.

Every kernel is one source ``rustqip_tpu_torch/csrc/<name>.cu`` with a plain
C interface. At first use it is compiled by nvcc with ``NVCC_FLAGS`` into a
shared library under ``build/rustqip_tpu_torch/`` (listed in .gitignore),
named by a hash of the source and the flags, and loaded with ctypes. Nothing
is built when a module is imported: the CPU paths never reach nvcc.

A kernel wrapper takes its typed entry point from ``function``, routes its
planes with ``on_card`` (CPU planes to its plain version) and launches
through ``launch``, which checks the CUDA error and counts the launch in
``LAUNCHES``. Each entry point returns a CUDA error code and takes the
stream last.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: Build directory (listed in .gitignore), beside the package's checkout.
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rustqip_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels build with the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, for its current source."""
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def _compile(name: str) -> float:
    out = library_path(name)
    if out.exists():
        return 0.0
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {name}.cu ({res.returncode}):\n{res.stdout}\n{res.stderr}"
        )
    os.replace(tmp, out)
    return time.perf_counter() - t0


def build(*names: str) -> Dict[str, float]:
    """Compile the named sources that are not built yet, one nvcc each, all
    started together; returns each one's seconds (0.0 when it was built
    already). Raises with nvcc's output on a failure."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futures = {name: pool.submit(_compile, name) for name in names}
        return {name: fut.result() for name, fut in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build(name)
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


#: The typed entry points loaded so far, by (source name, symbol). A tool
#: may put a variant's function in place of one (``tools/tile_ab.py``).
FUNCTIONS: Dict[Tuple[str, str], Callable[..., int]] = {}


def bind(lib: ctypes.CDLL, symbol: str, argtypes: Sequence) -> Callable[..., int]:
    """``lib``'s entry point ``symbol``, typed: ``argtypes`` in, a CUDA
    error code (``int``) out."""
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def function(name: str, symbol: str, argtypes: Sequence) -> Callable[..., int]:
    """The typed entry point ``symbol`` of ``csrc/<name>.cu``, built, loaded
    and typed at first use."""
    fn = FUNCTIONS.get((name, symbol))
    if fn is None:
        fn = FUNCTIONS[(name, symbol)] = bind(load(name), symbol, argtypes)
    return fn


#: Kernel launches, counted by ``launch`` and nowhere else (a reader takes
#: differences, or zeroes it with ``reset_launch_counts``):
#: ``window_sweep`` every launch of the window kernel, ``window_stream`` its
#: register path's among them, ``row_swap`` and ``row_swap_cross`` the
#: row-pair and the cross kernel of ``row_swap.cu``, ``plane_copy`` the copy
#: kernel, ``monomial_pass`` the monomial pass (``monomial_pass.cu``, loaded
#: at its first launch); ``KIND_PREFIX + kind`` the window launches whose
#: program holds a step of that kind.
LAUNCHES: Counter = Counter()
KIND_PREFIX = "window_kind:"


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def on_card(kernel: str, *planes: torch.Tensor) -> bool:
    """The plane check of every kernel wrapper: False for CPU planes (the
    wrapper takes its plain version), True for CUDA planes that are
    contiguous and 16-byte aligned. Raises ``ValueError`` for planes that do
    not share one device and dtype, for any other device, and for CUDA
    planes that are not contiguous or aligned."""
    first = planes[0]
    if any(x.device != first.device or x.dtype != first.dtype for x in planes):
        raise ValueError(f"{kernel}: planes must share one device and dtype")
    if first.device.type == "cpu":
        return False
    if first.device.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {first.device}")
    if not all(x.is_contiguous() for x in planes):
        raise ValueError(f"{kernel} takes contiguous planes")
    if any(x.data_ptr() % 16 for x in planes):
        raise ValueError(f"{kernel} needs 16-byte aligned planes")
    return True


def launch(kernel: str, fn: Callable[..., int], device, *args, also: Sequence[str] = ()) -> None:
    """Call the entry point ``fn`` with ``args`` and ``device``'s current
    stream, on ``device``. A non-zero return (a CUDA error) raises
    ``RuntimeError`` naming ``kernel``; otherwise the launch counts in
    ``LAUNCHES[kernel]`` and in each key of ``also``."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    LAUNCHES[kernel] += 1
    for key in also:
        LAUNCHES[key] += 1
