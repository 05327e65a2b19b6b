"""PDGN on PyTorch and CUDA: the H100 port of ``pdgn_tpu``.

A second package beside the JAX one, with the same layout: ``models``
(generator, discriminators), ``losses`` (LSGAN, Chamfer, shape-preserving),
``ops`` (kNN, gathers) and ``ops/kernels`` (the hand-written CUDA kernels of
``csrc/``, forward and backward, with their plain PyTorch versions),
``data`` (synthetic shapes), ``train`` (train step, trainer, sampler,
checkpoints, bulk generation) and ``cli``. It imports ``torch`` and
``numpy``, never JAX or ``pdgn_tpu``. Entry points run on CUDA unless the
caller passes ``device="cpu"``.
"""
