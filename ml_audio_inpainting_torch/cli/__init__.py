"""Command-line entry points of the port: ``inpaint`` and ``evaluate``."""
