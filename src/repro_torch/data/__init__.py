"""Synthetic corpora of the port (numpy copy of ``repro.data.corpus``)."""
