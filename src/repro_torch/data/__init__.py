"""Deterministic restart-safe data pipeline (numpy; the port's copy)."""
from . import pipeline  # noqa: F401
