"""Synthetic data generators of the port (numpy; ``repro.data``)."""
