"""Objectives of the port (orthonormal fair classification, DRO)."""
