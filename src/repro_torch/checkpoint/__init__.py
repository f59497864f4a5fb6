"""Parameter conversion between the reference and the port."""
