"""Op-level layer (L1): gate-op IR, constructors, and measurement."""
