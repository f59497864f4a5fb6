"""Dense model family of the port (torch)."""
