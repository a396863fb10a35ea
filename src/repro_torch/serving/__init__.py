"""Cascade serving: scheduler, slot arenas, the multi-tenant server."""
