"""Deterministic, restart-safe token streams."""
