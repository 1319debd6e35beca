"""Trajectory persistence of the port (ReplaySaver)."""
