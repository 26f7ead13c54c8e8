"""Command-line entry points of the port, mirroring ``src/repro/launch``."""
