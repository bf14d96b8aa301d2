"""Step builders of the port (mesh-free so far)."""
