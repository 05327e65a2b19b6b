"""Command-line interface of the PyTorch/CUDA port (the flags of
pdgn_tpu/cli.py, plus ``--device``).

``--phase train`` (synthetic data only) and ``--phase sample`` (bulk
generation) are ported; ``test`` exits with status 2 and says so. Run as::

    python -m pdgn_tpu_torch.cli --network PDGNet_v2 --model_dir run1 \\
        --phase train --dataset synthetic --max_epoch 1 --batch_size 35
    python -m pdgn_tpu_torch.cli --network PDGNet_v2 --model_dir run1 \\
        --phase sample --num_samples 256 --batch_size 128

Without ``--device cpu`` the run needs a CUDA card and fails loudly when
none is visible.
"""

from __future__ import annotations

import argparse
import os
import random
import sys


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="PDGN: progressive point-cloud GAN (PyTorch/CUDA port)")
    parser.add_argument('--phase', type=str, default='train',
                        help='train, test, or sample (bulk generation); '
                             'train and sample are ported')
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
                        help='reference-format G .pth, relative to '
                             '<checkpoint_dir>/<model_dir>/<network>')
    parser.add_argument('--pretrain_model_D', default=None)
    parser.add_argument('--softmax', default='True')
    parser.add_argument('--dataset', default='shapenet15k',
                        help='only synthetic is ported')
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
    parser.add_argument('--compute_dtype', type=str, default=None,
                        choices=[None, 'float32'],
                        help='only fp32 is ported')
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
    return args


def train(args: argparse.Namespace) -> None:
    """The train phase: a random seed per run, as the reference (main.py:
    79-82) and the JAX CLI; the trainer draws its weights' and noise's seeds
    from numpy's stream."""
    import numpy as np

    from pdgn_tpu_torch.train.trainer import ExperimentConfig, PDGNTrainer

    manual_seed = random.randint(1, 10000)
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
        synthetic_size=args.synthetic_size,
        max_steps_per_epoch=args.max_steps_per_epoch,
        base_points=args.base_points, device=args.device)
    trainer = PDGNTrainer(cfg)
    trainer.build_model()
    trainer.train()
    print(" [*] Training finished!")


def main(argv=None) -> None:
    args = parse_args(argv)
    print(f'****************network: {args.network}****************')
    if args.phase == 'train':
        train(args)
        return
    if args.phase != 'sample':
        print(f" [!] phase '{args.phase}' is not yet ported to "
              "pdgn_tpu_torch; use pdgn_tpu (main.py) for it.")
        sys.exit(2)

    from pdgn_tpu_torch.train.generate import generate
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
                      softmax=softmax, noise_dim=args.noise_dim)
    print(f" [*] Wrote {clouds.shape} to {out}")
    print(" [*] Sampling finished!")


if __name__ == '__main__':
    main()
