"""Host utilities of the port (configuration, numeric precision)."""
