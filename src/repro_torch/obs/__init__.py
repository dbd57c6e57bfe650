"""Observability substrate of the port (copy of ``repro.obs``): software
PMCs + request tracing under the same metric and event names, so the
``plan.launches.<op>`` counters, the ``launch_ms.<op>`` histogram and the
``prep`` / ``launch`` spans read the same in both packages. The port's
spans go further down than the JAX package's (``schema.EVENT_TYPES``)."""
from .metrics import (HIST_BOUNDS_MS, CounterDict, Histogram,
                      MetricsRegistry, Scope, default_registry,
                      reset_default_registry, scoped_int)
from .schema import (EVENT_FIELDS, EVENT_TYPES, ordered, telemetry_key)
from .trace import Tracer, emit, install_tracer, request, span, tracer

__all__ = [
    "CounterDict", "EVENT_FIELDS", "EVENT_TYPES", "HIST_BOUNDS_MS",
    "Histogram",
    "MetricsRegistry", "Scope", "Tracer", "default_registry", "emit",
    "install_tracer", "ordered", "request", "reset_default_registry",
    "scoped_int",
    "span", "telemetry_key", "tracer",
]
