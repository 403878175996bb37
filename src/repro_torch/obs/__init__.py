"""Observability for the port: span tracer, metrics registry and profiler
hooks, with the reference's span and metric names (``repro.obs``)."""
from . import metrics, profile, trace

__all__ = ["metrics", "profile", "trace"]
