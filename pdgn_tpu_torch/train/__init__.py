"""Sampling, checkpoints and bulk generation of the port."""
