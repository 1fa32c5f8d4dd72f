"""Inputs that hold the port's kernels to their semantics, for the tests and
``chip_smoke.py``; nothing on the engine's path imports this package."""
