"""Graph containers of the port."""
