"""Runtime arena race sanitizer (host-side, framework-free)."""
