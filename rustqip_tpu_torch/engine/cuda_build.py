"""Build and load the port's CUDA kernels.

Every kernel is one source ``rustqip_tpu_torch/csrc/<name>.cu`` with a plain
C interface. At first use it is compiled by nvcc with ``NVCC_FLAGS`` into a
shared library under ``build/rustqip_tpu_torch/`` (listed in .gitignore),
named by a hash of the source and the flags, and loaded with ctypes. Nothing
is built when a module is imported: the CPU paths never reach nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

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
