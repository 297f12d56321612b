"""Host-side utilities: typed errors, telemetry counters, timers, registry."""
