"""Synthetic scenes with exact ground truth, for tests and chip_smoke.py."""
