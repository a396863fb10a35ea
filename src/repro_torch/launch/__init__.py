"""Device roofline helpers for serving telemetry."""
