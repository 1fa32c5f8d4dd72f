"""Geometry, sampling and synthetic-scene utilities."""
