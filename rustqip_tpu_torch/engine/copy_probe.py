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

import torch

from rustqip_tpu_torch.engine import cuda_build

STRIPS = (1, 4)
#: The entry point's argument types (csrc/plane_copy.cu).
COPY_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def plane_copy_reference(xr: torch.Tensor, xi: torch.Tensor, out=None):
    """The plain version: ``Tensor.copy_`` into fresh planes or ``out``."""
    yr, yi = out if out is not None else (torch.empty_like(xr), torch.empty_like(xi))
    return yr.copy_(xr), yi.copy_(xi)


def plane_copy(xr: torch.Tensor, xi: torch.Tensor, out=None, strips: int = 1):
    """Copy a plane pair; returns ``(yr, yi)``. ``strips`` (1 or 4) is the
    number of contiguous strips of each plane the kernel streams at once on
    the card: each thread loads its 16-byte unit of every strip before it
    stores any (``csrc/plane_copy.cu``)."""
    if strips not in STRIPS:
        raise ValueError(f"plane_copy: strips must be one of {STRIPS}")
    yr, yi = out if out is not None else (torch.empty_like(xr), torch.empty_like(xi))
    if not cuda_build.on_card("plane_copy", xr, xi, yr, yi):
        return plane_copy_reference(xr, xi, (yr, yi))
    if yr.shape != xr.shape or yi.shape != xr.shape or xi.shape != xr.shape:
        raise ValueError("plane_copy: planes must share one shape")
    nbytes = xr.numel() * xr.element_size()
    if nbytes % (16 * strips):
        raise ValueError(f"plane_copy: {nbytes} bytes is not a multiple of {16 * strips}")
    cuda_build.launch(
        "plane_copy", cuda_build.function("plane_copy", "rq_plane_copy", COPY_ARGTYPES),
        xr.device, xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(), nbytes, strips,
    )
    return yr, yi
