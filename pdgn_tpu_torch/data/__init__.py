"""Datasets of the port (synthetic shapes; the hdf5 datasets wait)."""
