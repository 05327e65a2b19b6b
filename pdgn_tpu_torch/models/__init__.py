"""Generator and layers of the port."""
