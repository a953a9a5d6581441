"""Shared parts of the benchmark: finding files by name, reading traces,
assembling the result line."""
