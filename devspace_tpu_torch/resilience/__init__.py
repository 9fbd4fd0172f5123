"""Resilience primitives: retry with backoff."""
