"""The port's version: the JAX package's string, which it tracks release
for release (pyproject.toml reads that one; tests hold the two equal)."""

__version__ = "0.1.0"
