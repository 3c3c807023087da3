"""Host-side utilities of the port (event streams)."""
