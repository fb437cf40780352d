"""Host-side core utilities of the port (the clock)."""
