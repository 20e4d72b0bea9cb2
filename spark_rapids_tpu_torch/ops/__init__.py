"""Columnar kernel substrate: torch ops and the hand-written kernels."""
