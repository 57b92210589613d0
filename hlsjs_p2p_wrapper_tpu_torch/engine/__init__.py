"""Host-side pieces of the reference's ``engine/`` package that the
port's device model needs (copied, not imported)."""
