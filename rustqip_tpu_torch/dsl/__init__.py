"""DSL layer (L3); only ``negate_bitmask`` is ported so far."""
