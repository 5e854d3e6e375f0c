"""Utility subpackage (port of ``rustqip_tpu/utils/``): bit math here;
``serialize`` (JSON circuits, state snapshots) and ``observe`` (statistics,
profilers, trace) are imported as modules."""

from rustqip_tpu_torch.utils.bits import (
    entwine_bits,
    extract_bits,
    flip_bits,
    full_to_sub,
    get_bit,
    get_flat_index,
    set_bit,
    sub_to_full,
    transpose_sparse,
)

__all__ = [
    "entwine_bits",
    "extract_bits",
    "flip_bits",
    "full_to_sub",
    "get_bit",
    "get_flat_index",
    "set_bit",
    "sub_to_full",
    "transpose_sparse",
]
