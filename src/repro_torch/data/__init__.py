"""Synthetic data streams of the port (NumPy, seeded)."""
