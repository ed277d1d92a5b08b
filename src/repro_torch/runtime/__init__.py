"""Fault tolerance of the port (``repro.runtime``'s counterpart)."""
