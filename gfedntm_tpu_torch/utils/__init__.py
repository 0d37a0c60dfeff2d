"""Serialization and telemetry."""
