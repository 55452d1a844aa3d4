"""Training runtime of the port."""
