"""The plane-pair copy: one read and one write of a state's (re, im) planes.

``plane_copy`` copies both planes to fresh planes (or into ``out``, which
may be the input itself: an in-place copy, a write of the same values). On
a CUDA tensor it launches the Hopper kernel of
``rustqip_tpu_torch/csrc/plane_copy.cu`` and counts the launch, or raises;
on a CPU tensor it takes the plain version, ``Tensor.copy_``. Its time on
the card is the copy floor every memory-bound kernel is held against; the
port also uses it for the copies a wide controlled op takes of its input
(``real_apply._control_ri``).
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from rustqip_tpu_torch.engine import cuda_build

#: Kernel launches, counted by ``plane_copy`` where it launches and nowhere
#: else.
LAUNCHES: Counter = Counter()
STRIPS = (1, 4)


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def plane_copy_reference(xr: torch.Tensor, xi: torch.Tensor, out=None):
    """The plain version: ``Tensor.copy_`` into fresh planes or ``out``."""
    yr, yi = out if out is not None else (torch.empty_like(xr), torch.empty_like(xi))
    return yr.copy_(xr), yi.copy_(xi)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("plane_copy")
        fn = lib.rq_plane_copy
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def plane_copy(xr: torch.Tensor, xi: torch.Tensor, out=None, strips: int = 1):
    """Copy a plane pair; returns ``(yr, yi)``. ``strips`` (1 or 4) is the
    number of contiguous strips of each plane the kernel streams at once on
    the card: each thread loads its 16-byte unit of every strip before it
    stores any (``csrc/plane_copy.cu``)."""
    if strips not in STRIPS:
        raise ValueError(f"plane_copy: strips must be one of {STRIPS}")
    if xr.device.type == "cpu":
        return plane_copy_reference(xr, xi, out)
    if xr.device.type != "cuda":
        raise ValueError(f"plane_copy: no kernel for device {xr.device}")
    yr, yi = out if out is not None else (torch.empty_like(xr), torch.empty_like(xi))
    planes = (xr, xi, yr, yi)
    if any(x.device != xr.device or x.dtype != xr.dtype or x.shape != xr.shape
           for x in planes):
        raise ValueError("plane_copy: planes must share one device, dtype and shape")
    if not all(x.is_contiguous() for x in planes):
        raise ValueError("plane_copy takes contiguous planes")
    if any(x.data_ptr() % 16 for x in planes):
        raise ValueError("plane_copy needs 16-byte aligned planes")
    nbytes = xr.numel() * xr.element_size()
    if nbytes % (16 * strips):
        raise ValueError(f"plane_copy: {nbytes} bytes is not a multiple of {16 * strips}")
    with torch.cuda.device(xr.device):
        err = _lib().rq_plane_copy(
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(), nbytes,
            strips, torch.cuda.current_stream(xr.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"plane_copy kernel launch failed: CUDA error {err}")
    LAUNCHES["plane_copy"] += 1
    return yr, yi
