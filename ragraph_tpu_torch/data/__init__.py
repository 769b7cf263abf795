"""Host-side data of the port (numpy only)."""
