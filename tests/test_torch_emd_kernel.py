"""What ``csrc/emd_cd.cu`` changes about the approxmatch, held on the CPU
where the kernel cannot run: the Morton order it visits the points in
(:func:`morton_order`, computed by the same code for the card), the boxes
it culls by (:func:`tile_boxes`), and the plain version's sensitivity to
both changes of the redesign: K taken by ``ex2.approx.f32`` (relative error
at most 2^-22 by the PTX ISA) and the points reordered. The cost must stay
within 2e-3 and the Chamfer distance within 1e-5 of the plain version on
the points as given, the kernel's own tolerances.
"""

import numpy as np
import pytest
import torch

from torch_port_util import rel

import pdgn_tpu_torch.losses.emd as emd_mod
from pdgn_tpu_torch.data.shapenet import SyntheticShapes
from pdgn_tpu_torch.ops.kernels.emd_cd import (BOX, emd_cd, emd_cd_plain,
                                               morton_order, tile_boxes)
from pdgn_tpu_torch.train.trainer import normalize_point_clouds

N = 512


def _eval_sets():
    """Two kinds of clouds, as the test phase pairs them: bbox-normalised
    generated-like shapes against shape_unit references."""
    ref = SyntheticShapes(size=4, num_points=N).full_clouds()
    gen = normalize_point_clouds(ref[2:], "shape_bbox")
    return torch.from_numpy(gen), torch.from_numpy(ref[:2])


def test_morton_order_is_a_stable_spatial_permutation():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 700, 3, generator=g)
    x[:, 350:] = x[:, :350]                  # equal points, equal codes
    order = morton_order(x)
    assert order.shape == (3, 700) and order.dtype == torch.int64
    for s in range(3):
        assert torch.equal(order[s].sort().values, torch.arange(700))
        pos = torch.empty(700, dtype=torch.int64)
        pos[order[s]] = torch.arange(700)
        # a stable sort keeps equal codes in their given order
        assert bool((pos[:350] < pos[350:]).all())
    xs = torch.gather(x, 1, order[..., None].expand(3, 700, 3))
    step = (xs[:, 1:] - xs[:, :-1]).norm(dim=-1).mean()
    assert float(step) < 0.25 * float((x[:, 1:] - x[:, :-1]).norm(dim=-1)
                                      .mean())
    assert torch.equal(morton_order(x.clone()), order)


@pytest.mark.parametrize("n", [100, 2048])
def test_tile_boxes_hold_their_points(n):
    g = torch.Generator().manual_seed(n)
    x = torch.randn(2, n, 3, generator=g)
    boxes = tile_boxes(x)
    assert boxes.shape == (2, -(-n // BOX), 6)
    for t in range(boxes.shape[1]):
        pts = x[:, t * BOX:(t + 1) * BOX]
        assert torch.equal(boxes[:, t, :3], pts.amin(1))
        assert torch.equal(boxes[:, t, 3:], pts.amax(1))


def test_emd_cd_cpu_route_is_the_plain_version():
    a, b = _eval_sets()
    cd, cost = emd_cd(a, b)
    cd_p, cost_p = emd_cd_plain(a, b)
    assert torch.equal(cd, cd_p) and torch.equal(cost, cost_p)


@pytest.mark.parametrize("eps", [2.0 ** -22, 2.0 ** -20])
def test_plain_version_holds_the_ex2_error_and_the_morton_order(
        monkeypatch, eps):
    """K perturbed by +-eps (random signs; eps the PTX ISA's bound for
    ex2.approx.f32 and four times it) on Morton-ordered points: cost rel
    <= 2e-3 and cd rel <= 1e-5 of the plain version on the given order."""
    a, b = _eval_sets()
    cd0, cost0 = emd_cd_plain(a, b)
    ao = torch.gather(a, 1, morton_order(a)[..., None].expand(-1, N, 3))
    bo = torch.gather(b, 1, morton_order(b)[..., None].expand(-1, N, 3))
    cd1, cost1 = emd_cd_plain(ao, bo)
    assert rel(cd1, cd0) <= 1e-5 and rel(cost1, cost0) <= 2e-3

    exp = torch.exp
    g = torch.Generator().manual_seed(22)

    def noisy_exp(x):
        sign = torch.randint(0, 2, x.shape, generator=g).float() * 2 - 1
        return exp(x) * (1.0 + eps * sign)

    monkeypatch.setattr(emd_mod.torch, "exp", noisy_exp)
    cd2, cost2 = emd_cd_plain(ao, bo)
    monkeypatch.undo()
    assert rel(cd2, cd0) <= 1e-5
    assert rel(cost2, cost0) <= 2e-3
    assert np.isfinite(cost2.numpy()).all()
