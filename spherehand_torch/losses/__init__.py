"""Self-supervision and synthetic losses of the port."""
