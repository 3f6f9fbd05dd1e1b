"""Utilities: step timing and tracing."""
