"""PDGN on PyTorch and CUDA: the H100 port of ``pdgn_tpu``.

A second package beside the JAX one, with the same layout: ``models``
(generator, discriminators), ``losses`` (LSGAN, Chamfer, approximate EMD,
shape-preserving), ``ops`` (kNN, gathers) and ``ops/kernels`` (the
hand-written CUDA kernels of ``csrc/``, forward and backward, with their
plain PyTorch versions), ``eval`` (the MMD/COV/1-NNA/JSD metric suite),
``data`` (shapenet15k through the package's own hdf5 reader, ModelNet,
ShapeNet-part, synthetic shapes, augmentations, the pinned-memory loader),
``train`` (train step, trainer with the train and test phases, sampler,
``.pth`` and msgpack checkpoints, bulk generation), ``parallel`` (data
parallelism over ``torch.distributed``), ``native`` (the reference
kernels' algorithms in scalar C++ on the host, built with g++: CPU oracles
for kNN, Chamfer, approxmatch and FPS), ``convert_ckpt`` (the weight maps
to and from the JAX package's layouts, and ``python -m
pdgn_tpu_torch.convert_ckpt``, reference ``.pth`` to msgpack bundles),
``utils`` and ``cli`` (also ``python -m pdgn_tpu_torch``). It imports
``torch``, ``numpy`` and ``scipy``, never JAX, ``pdgn_tpu``, h5py or
msgpack.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
