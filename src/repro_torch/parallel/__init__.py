"""Step functions of the port: one rank's training steps over a PierMesh, and
the paged serve steps."""
