"""Experiment configurations of the port (copy of ``repro.configs``'s
sparse-PCA part)."""
