"""PDGN on PyTorch and CUDA: the H100 port of ``pdgn_tpu``.

A second package beside the JAX one, with the same layout: ``models``
(generator), ``ops`` (kNN, gathers) and ``ops/kernels`` (the hand-written
CUDA kernels of ``csrc/`` with their plain PyTorch versions), ``train``
(sampler, checkpoints, bulk generation) and ``cli``. It imports ``torch``
and ``numpy``, never JAX or ``pdgn_tpu``. Entry points run on CUDA unless
the caller passes ``device="cpu"``.
"""
