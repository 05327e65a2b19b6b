"""Losses of the port (LSGAN, Chamfer, approximate EMD, shape-preserving)."""
