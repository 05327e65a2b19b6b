"""Point ops of the port (plain PyTorch) and its kernels (``kernels``)."""
