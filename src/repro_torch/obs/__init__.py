"""Observability for the port: span tracer, metrics registry, health rules
and watchdogs, the live telemetry exporter, and profiler hooks, with the
reference's span and metric names (``repro.obs``)."""
from . import export, health, metrics, profile, trace
from .export import TelemetryExporter
from .health import HealthEngine, HealthRule, HealthStatus

__all__ = ["export", "health", "metrics", "profile", "trace",
           "TelemetryExporter", "HealthEngine", "HealthRule", "HealthStatus"]
