"""Host utilities of the port (configuration)."""
