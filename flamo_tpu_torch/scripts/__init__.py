"""Command-line benchmarks of the port (counterparts of ``scripts/``)."""
