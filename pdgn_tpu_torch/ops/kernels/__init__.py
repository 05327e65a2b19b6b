"""Hand-written CUDA kernels of the port (sources in ``pdgn_tpu_torch/csrc``)
with their plain PyTorch versions; ``_lib.LAUNCHES`` counts launches."""
