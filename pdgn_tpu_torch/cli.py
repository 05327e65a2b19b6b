"""Command-line interface of the PyTorch/CUDA port (every flag of
pdgn_tpu/cli.py, ``--device`` taking ``cuda`` or ``cpu``).

``--phase train``, ``--phase test`` (shapenet15k, ModelNet10/40 or
synthetic data) and ``--phase sample`` (bulk generation). Run as
``python -m pdgn_tpu_torch`` (the ``main.py``-style entry) or
``python -m pdgn_tpu_torch.cli``::

    python -m pdgn_tpu_torch --network PDGNet_v2 --model_dir run1 \\
        --phase train --dataset shapenet15k --data_root shapenet.hdf5 \\
        --choice chair --max_epoch 1 --batch_size 35
    python -m pdgn_tpu_torch --network PDGNet_v2 --model_dir run1 \\
        --phase test --dataset shapenet15k --data_root shapenet.hdf5 \\
        --choice chair --pretrain_model_G 1_chair_G.pth \\
        --pretrain_model_D 1_chair_D.pth
    python -m pdgn_tpu_torch --network PDGNet_v2 --model_dir run1 \\
        --phase sample --num_samples 256 --batch_size 128

``--pretrain_model_G/_D`` take ``.pth`` bundles or the JAX package's
``.msgpack`` ones. The train phase copies the entry script and the port's
generator source into ``<checkpoint_dir>/<model_dir>``; ``--profile_dir``
writes a ``torch.profiler`` trace of global steps 2..4 there. Without
``--device cpu`` the run needs a CUDA card and fails loudly when none is
visible. The port builds only exact kNN graphs: ``--exact_knn 0`` (the
fast bf16 graphs of the JAX package) is refused (exit 2).
``--compute_dtype bfloat16`` runs the generator in the JAX package's bf16
policy in every phase (train, test, sample): bf16 activations and product
operands through the kernels' bf16 instances, forward and backward, with
fp32 parameters, BN statistics, optimizer state and clouds.
``--d_compute_dtype bfloat16`` computes the discriminators' conv stacks in
bf16 too; they stay fp32 by default, as in the JAX package, whose bf16
discriminators collapsed LSGAN training on the TPU.

Data parallelism, one process per device, as the JAX CLI's mesh over every
device::

    torchrun --nproc_per_node=W -m pdgn_tpu_torch --phase train ...

``torchrun`` sets ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``; each rank
joins the group (NCCL on the card, gloo with ``--device cpu``) and runs on
``cuda:LOCAL_RANK``. ``--batch_size`` is the global batch, split over the
ranks by rows (uneven shards allowed, at least one row a rank), with global
batch-norm statistics; the test and sample phases hand whole batches to the
ranks in turn; rank 0 writes the bundles, logs and outputs. A run that
``torchrun`` did not start makes no group: the one-process run.
"""

from __future__ import annotations

import argparse
import os
import random
import shutil
import sys


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="PDGN: progressive point-cloud GAN (PyTorch/CUDA port)")
    parser.add_argument('--phase', type=str, default='train',
                        help='train, test (sampling + metric suite), or '
                             'sample (bulk generation)')
    parser.add_argument('--num_samples', type=int, default=128,
                        help='clouds to generate in --phase sample')
    parser.add_argument('--workers', type=int, default=4,
                        help='(accepted for parity)')
    parser.add_argument('--gpu', type=int, default=0,
                        help='(accepted for parity)')
    parser.add_argument('--batch_size', type=int, default=50)
    parser.add_argument('--num_point', type=int, default=2048)
    parser.add_argument('--num_k', type=int, default=20,
                        help='number of the knn graph point')
    parser.add_argument('--learning_rate', type=float, default=0.0001)
    parser.add_argument('--max_epoch', type=int, default=300)
    parser.add_argument('--noise_dim', type=int, default=128)
    parser.add_argument('--optimizer', default='adam')
    parser.add_argument('--debug', type=bool, default=True)
    parser.add_argument('--data_root',
                        default='shapenet.hdf5')
    parser.add_argument('--log_info', default='log_info.txt')
    parser.add_argument('--model_dir', help='model dir [must input]')
    parser.add_argument('--checkpoint_dir', default='checkpoint')
    parser.add_argument('--snapshot', type=int, default=20)
    parser.add_argument('--choice', default=None, help='choice class')
    parser.add_argument('--network', default=None,
                        help='PDGNet or PDGNet_v2')
    parser.add_argument('--savename', default=None)
    parser.add_argument('--pretrain_model_G', default=None,
                        help='G bundle (.pth, or the JAX package\'s '
                             '.msgpack), relative to '
                             '<checkpoint_dir>/<model_dir>/<network>')
    parser.add_argument('--pretrain_model_D', default=None)
    parser.add_argument('--softmax', default='True')
    parser.add_argument('--dataset', default='shapenet15k',
                        help='[shapenet15k, modelnet10, modelnet40, '
                             'synthetic]')
    parser.add_argument('--normalize', type=str, default='shape_bbox',
                        choices=[None, 'shape_unit', 'shape_bbox'])
    parser.add_argument('--seed', type=int, default=9999)
    parser.add_argument('--save_dir', type=str, default='./results')
    parser.add_argument('--device', type=str, default='cuda',
                        choices=['cuda', 'cpu'],
                        help='cuda (default; fails without a card) or cpu '
                             '(the plain PyTorch path)')
    parser.add_argument('--max_steps_per_epoch', type=int, default=None)
    parser.add_argument('--synthetic_size', type=int, default=64)
    parser.add_argument('--base_points', type=int, default=128,
                        help='generator stage-1 points (128 = reference; '
                             'smaller shrinks every stage)')
    parser.add_argument('--profile_dir', type=str, default=None,
                        help='write a torch.profiler trace of steps 2..4')
    parser.add_argument('--compute_dtype', type=str, default=None,
                        choices=[None, 'float32', 'bfloat16'],
                        help='generator compute dtype for the large '
                             'activations (parameters, BN statistics and '
                             'the coordinate heads stay fp32); default fp32')
    parser.add_argument('--d_compute_dtype', type=str, default=None,
                        choices=[None, 'float32', 'bfloat16'],
                        help='discriminator conv-stack dtype. Stays fp32 '
                             'even under --compute_dtype bfloat16: bf16 '
                             'discriminators collapsed LSGAN training in '
                             'the JAX package on the TPU')
    parser.add_argument('--exact_knn', type=str, default=None,
                        choices=[None, '0', '1'],
                        help='fp32-exact kNN graphs: the port builds only '
                             'these; 0 (fast bf16 graphs) is not ported')
    return check_args(parser.parse_args(argv))


def check_args(args: argparse.Namespace) -> argparse.Namespace:
    if args.model_dir is None:
        print('please create model dir')
        sys.exit(1)
    if args.network is None:
        print('please select model!!!')
        sys.exit(1)
    if args.network not in ('PDGNet', 'PDGNet_v2'):
        print('select model error!!!')
        sys.exit(1)
    if args.batch_size < 1 or args.num_samples < 1:
        print('batch_size and num_samples must be >= 1')
        sys.exit(1)
    if args.exact_knn == '0':
        print(" [!] --exact_knn 0 (fast bf16 kNN graphs) is not ported to "
              "pdgn_tpu_torch: it builds exact graphs only")
        sys.exit(2)
    return args


def _mesh(args: argparse.Namespace):
    """The data axis when ``torchrun`` started this process, else None. A
    failed initialisation raises."""
    import torch.distributed as dist

    from pdgn_tpu_torch.parallel import initialize_distributed, make_mesh

    initialize_distributed(device=args.device)
    return make_mesh(args.device) if dist.is_initialized() else None


def _trainer(args: argparse.Namespace, mesh=None):
    """The trainer of the train and test phases, with the run's random
    seed drawn and set as the reference (main.py:79-82) and the JAX CLI
    do (rank 0's on every rank of a group); the trainer draws its weights'
    and noise's seeds from numpy's stream, and the test phase re-seeds from
    ``--seed``."""
    import numpy as np

    from pdgn_tpu_torch.train.trainer import ExperimentConfig, PDGNTrainer

    manual_seed = random.randint(1, 10000)
    if mesh is not None:
        manual_seed = mesh.broadcast_int(manual_seed)
    print("Random Seed: ", manual_seed)
    random.seed(manual_seed)
    np.random.seed(manual_seed)
    cfg = ExperimentConfig(
        network=args.network, batch_size=args.batch_size,
        num_point=args.num_point, num_k=args.num_k,
        learning_rate=args.learning_rate, max_epoch=args.max_epoch,
        noise_dim=args.noise_dim, log_info=args.log_info,
        model_dir=args.model_dir, checkpoint_dir=args.checkpoint_dir,
        snapshot=args.snapshot, choice=args.choice,
        pretrain_model_G=args.pretrain_model_G,
        pretrain_model_D=args.pretrain_model_D,
        softmax=(args.softmax == 'True'), dataset=args.dataset,
        data_root=args.data_root, synthetic_size=args.synthetic_size,
        max_steps_per_epoch=args.max_steps_per_epoch,
        base_points=args.base_points, normalize=args.normalize,
        seed=args.seed, save_dir=args.save_dir, device=args.device,
        profile_dir=args.profile_dir, compute_dtype=args.compute_dtype,
        d_compute_dtype=args.d_compute_dtype)
    trainer = PDGNTrainer(cfg, mesh)
    trainer.build_model()
    return trainer


def _copy_sources(args: argparse.Namespace) -> None:
    """The train phase's backup of the entry script and the generator
    source into ``<checkpoint_dir>/<model_dir>`` (reference main.py:97-99,
    pdgn_tpu/cli.py:178-187); a source that cannot be copied is skipped."""
    import pdgn_tpu_torch.models.generator as generator

    dst = os.path.join(args.checkpoint_dir, args.model_dir)
    os.makedirs(dst, exist_ok=True)
    for src in (os.path.abspath(sys.argv[0]), generator.__file__):
        try:
            shutil.copy(src, dst)
        except (OSError, shutil.SameFileError):
            pass


def main(argv=None):
    """Runs one phase; returns the trainer of a train or test phase (its
    step times and metrics), else None. A process group this call makes
    (from ``torchrun``'s environment) is destroyed when it returns."""
    import torch.distributed as dist

    args = parse_args(argv)
    owned = not dist.is_initialized()
    mesh = None
    try:
        mesh = _mesh(args)
        return _run(args, mesh)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def _run(args: argparse.Namespace, mesh):
    print(f'****************network: {args.network}****************')
    if args.phase == 'train':
        trainer = _trainer(args, mesh)
        if mesh is None or mesh.rank == 0:
            _copy_sources(args)
        trainer.train()
        print(" [*] Training finished!")
        return trainer
    if args.phase == 'test':
        trainer = _trainer(args, mesh)
        trainer.test()
        print(" [*] Test finished!")
        return trainer
    if args.phase == 'cls':
        print(" [!] phase 'cls' maps to extract_feature(), which the "
              "reference never defines (dead phase, main.py:108-109); "
              "nothing to run.")
        sys.exit(1)
    if args.phase != 'sample':
        print(f" [!] unknown phase '{args.phase}'")
        sys.exit(2)

    from pdgn_tpu_torch.train.generate import generate
    from pdgn_tpu_torch.train.trainer import generator_dtype
    from pdgn_tpu_torch.utils.misc import seed_all

    seed_all(args.seed)
    ckpt = None
    if args.pretrain_model_G is not None:
        ckpt = os.path.join(args.checkpoint_dir, args.model_dir,
                            args.network, args.pretrain_model_G)
    softmax = args.softmax == 'True' if args.network == 'PDGNet' else True
    out = os.path.join(args.save_dir,
                       f"samples_{args.model_dir}_{args.num_samples}.npy")
    clouds = generate(args.num_samples, args.batch_size, args.seed,
                      device=args.device, out_path=out,
                      num_point=args.num_point, num_k=args.num_k,
                      base_points=args.base_points, pretrain_model_G=ckpt,
                      softmax=softmax, noise_dim=args.noise_dim,
                      dtype=generator_dtype(args.compute_dtype), mesh=mesh)
    print(f" [*] Wrote {clouds.shape} to {out}")
    print(" [*] Sampling finished!")


if __name__ == '__main__':
    main()
