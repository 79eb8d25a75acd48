"""The general part of the benchmark: registry, traffic, window,
trace, check."""
