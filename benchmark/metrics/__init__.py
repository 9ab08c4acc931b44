"""The per-layer metrics: one reader a metric, ``<name>.py`` with
``read(trace) -> float or None`` (None where it finds nothing to read; the
harness then leaves the metric out of the line)."""
