"""Player-side constants the port's device model shares with the
reference's ``core/`` (copied, not imported)."""
