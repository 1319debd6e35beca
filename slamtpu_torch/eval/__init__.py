"""Trajectory evaluation (absolute trajectory error)."""
