"""Helpers for driving the port (deterministic corpus)."""
