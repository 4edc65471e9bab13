"""Command-line entry points (``repro/launch``): ``serve``."""
