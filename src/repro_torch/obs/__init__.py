"""Compression observability: a metrics registry, calibration telemetry,
decomposition reports and the quality-report CLI."""
