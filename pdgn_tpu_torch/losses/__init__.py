"""Training losses of the port (LSGAN, Chamfer, shape-preserving)."""
