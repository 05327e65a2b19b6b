"""The port's point-op library (``pdgn_tpu_torch.ops``) against the JAX
package's (``pdgn_tpu.ops``) on the CPU, on the same numpy inputs (B=2,
N <= 256), and against the scalar numpy oracles of ``tests/test_ops.py``.

Tolerances: indices equal (inputs without near-ties, plus tie cases of
duplicated points, where the lower index comes first); gathers and edge
features exact; distances, weights and interpolations rel <= 1e-6 (``rel``
= max |a - b| / max |b|); integer counts equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import rel, t

from pdgn_tpu import ops as jops
from pdgn_tpu.ops.edges import neighbor_features as j_neighbor_features
from pdgn_tpu_torch import ops
from pdgn_tpu_torch.ops.kernels import _lib
from tests.test_ops import np_ballquery, np_fps, np_knnquery

TOL = 1e-6


def cloud(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def duplicated(seed, B, n, C):
    """A cloud whose every point appears twice (rows i and i + n): exact
    distance ties, where the lower index must come first."""
    x = cloud(seed, B, n, C)
    return np.concatenate([x, x], axis=1)


def j(x):
    return jnp.asarray(x)


def test_public_names_match_the_jax_package():
    assert set(jops.__all__) <= set(ops.__all__)
    assert set(ops.__all__) - set(jops.__all__) == {"neighbor_features"}
    assert all(callable(getattr(ops, name)) for name in ops.__all__)


# ----------------------------------------------------------- pairwise, knn
@pytest.mark.parametrize("C", [3, 16])
def test_pairwise_sqdist_matches_jax(C):
    x, y = cloud(0, 2, 40, C), cloud(1, 2, 56, C)
    assert rel(ops.pairwise_sqdist(t(x), t(y)),
               jops.pairwise_sqdist(j(x), j(y))) <= TOL
    assert rel(ops.self_pairwise_sqdist(t(x)),
               jops.self_pairwise_sqdist(j(x))) <= TOL


@pytest.mark.parametrize("C,k,centers", [(3, 8, True), (3, 20, False),
                                         (16, 5, True), (32, 12, False)])
def test_knn_matches_jax(C, k, centers):
    xyz = cloud(2, 2, 200, C)
    ctr = cloud(3, 2, 70, C) if centers else None
    got = ops.knn(t(xyz), None if ctr is None else t(ctr), k)
    want = jops.knn(j(xyz), None if ctr is None else j(ctr), k)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), np_knnquery(xyz, xyz if ctr is None else ctr, k))


def test_knn_return_dist_and_naive_match_jax():
    xyz, ctr = cloud(4, 2, 120, 3), cloud(5, 2, 30, 3)
    idx, d = ops.knn(t(xyz), t(ctr), 6, return_dist=True)
    j_idx, j_d = jops.knn(j(xyz), j(ctr), 6, return_dist=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    assert rel(d, j_d) <= TOL
    np.testing.assert_array_equal(ops.knn_naive(t(xyz), t(ctr), 6).numpy(),
                                  np.asarray(jops.knn_naive(j(xyz), j(ctr),
                                                            6)))


@pytest.mark.parametrize("C", [3, 8])
def test_knn_ties_put_the_lower_index_first(C):
    xyz = duplicated(6, 2, 60, C)
    got = ops.knn(t(xyz), None, 9).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.knn(j(xyz), None, 9)))
    # each point's duplicate follows it; a lower-index copy comes first
    n = 60
    first = np.minimum(np.arange(2 * n) % n, np.arange(2 * n))
    np.testing.assert_array_equal(got[:, :, 0], np.broadcast_to(first,
                                                                 (2, 2 * n)))
    np.testing.assert_array_equal(got[:, :, 1], got[:, :, 0] + n)


def test_knn_beyond_the_kernel_width_takes_the_plain_route():
    xyz = cloud(7, 1, 200, 3)
    got = ops.knn(t(xyz), None, 130)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jops.knn(j(xyz), None, 130)))


def test_topk_ascending_idx_matches_jax():
    from pdgn_tpu.ops.knn import topk_ascending_idx as j_topk
    from pdgn_tpu_torch.ops.knn import topk_ascending_idx

    d = np.round(cloud(40, 2, 30, 50), 1)        # many exact ties
    np.testing.assert_array_equal(topk_ascending_idx(t(d), 12).numpy(),
                                  np.asarray(j_topk(j(d), 12)))


def test_knn_exclude_first_matches_jax():
    x = cloud(8, 2, 50, 8)
    d = ops.self_pairwise_sqdist(t(x))
    np.testing.assert_array_equal(
        ops.knn_exclude_first(d, 5).numpy(),
        np.asarray(jops.knn_exclude_first(jops.self_pairwise_sqdist(j(x)),
                                          5)))


# --------------------------------------------------------------- ballquery
@pytest.mark.parametrize("radius,nsample", [(0.3, 8), (0.05, 4), (2.0, 16)])
def test_ballquery_matches_jax(radius, nsample):
    rng = np.random.RandomState(9)
    xyz = rng.rand(2, 150, 3).astype(np.float32)
    ctr = rng.rand(2, 40, 3).astype(np.float32)
    got = ops.ballquery(radius, nsample, t(xyz), t(ctr))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.ballquery(radius, nsample, j(xyz),
                                               j(ctr))))
    np.testing.assert_array_equal(got.numpy(),
                                  np_ballquery(radius, nsample, xyz, ctr))


# ----------------------------------------------------------------- grouping
def test_grouping_and_its_gradient_match_jax():
    import jax

    fea = cloud(41, 2, 50, 7)
    idx = np.random.RandomState(42).randint(0, 50, (2, 20, 6)).astype(
        np.int32)
    ct = cloud(43, 2, 20, 6, 7)
    ft = t(fea).requires_grad_(True)
    got = ops.grouping(ft, t(idx))
    np.testing.assert_array_equal(got.detach().numpy(),
                                  np.asarray(jops.grouping(j(fea), j(idx))))
    (got * t(ct)).sum().backward()
    want = jax.grad(lambda f: jnp.sum(jops.grouping(f, j(idx)) * j(ct)))(
        j(fea))
    assert rel(ft.grad, want) <= TOL


def test_grouping_int_matches_jax():
    rng = np.random.RandomState(10)
    labels = rng.randint(0, 9, size=(2, 30)).astype(np.int64)
    idx = rng.randint(0, 30, size=(2, 7, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        ops.grouping_int(t(labels), t(idx)).numpy(),
        np.asarray(jops.grouping_int(j(labels), j(idx))))


@pytest.mark.parametrize("radius", [None, 0.4])
def test_group_xyz_matches_jax(radius):
    xyz, ctr = cloud(11, 2, 180, 3, scale=0.3), cloud(12, 2, 48, 3,
                                                      scale=0.3)
    got = ops.group_xyz(t(xyz), t(ctr), nsample=10, radius=radius)
    want = jops.group_xyz(j(xyz), j(ctr), nsample=10, radius=radius)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("radius,use_xyz,with_features",
                         [(None, True, True), (0.5, True, True),
                          (None, False, True), (None, True, False)])
def test_query_and_group_matches_jax(radius, use_xyz, with_features):
    xyz, ctr = cloud(13, 2, 160, 3, scale=0.3), cloud(14, 2, 40, 3,
                                                      scale=0.3)
    fea = cloud(15, 2, 160, 5) if with_features else None
    got = ops.query_and_group(t(xyz), t(ctr),
                              None if fea is None else t(fea), nsample=12,
                              radius=radius, use_xyz=use_xyz)
    want = jops.query_and_group(j(xyz), j(ctr),
                                None if fea is None else j(fea), nsample=12,
                                radius=radius, use_xyz=use_xyz)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        ops.query_and_group(t(xyz), t(ctr), nsample=4, use_xyz=False)


def test_le_query_and_group_family_matches_jax():
    xyz, ctr = cloud(16, 2, 100, 3, scale=0.3), cloud(17, 2, 30, 3,
                                                      scale=0.3)
    fea = cloud(18, 2, 100, 6)
    for got, want in zip(
            ops.le_query_and_group(t(xyz), t(ctr), t(fea), nsample=8),
            jops.le_query_and_group(j(xyz), j(ctr), j(fea), nsample=8)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(
            ops.le_query_and_group_same_size(t(xyz), None, t(fea),
                                             nsample=8, radius=0.3),
            jops.le_query_and_group_same_size(j(xyz), None, j(fea),
                                              nsample=8, radius=0.3)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        ops.le_query_and_group_only_feature(t(xyz), t(ctr), t(fea),
                                            nsample=8).numpy(),
        np.asarray(jops.le_query_and_group_only_feature(j(xyz), j(ctr),
                                                        j(fea), nsample=8)))
    with pytest.raises(ValueError):
        ops.le_query_and_group_same_size(t(xyz), t(ctr), t(fea))
    with pytest.raises(ValueError):
        ops.le_query_and_group(t(xyz), t(ctr), None)


def test_query_and_group_dilate_matches_jax_for_the_same_slots():
    """The slot draw comes from a torch generator; JAX gets the port's
    slots through ``idx``, so both group the same subset."""
    xyz, ctr = cloud(19, 2, 140, 3, scale=0.3), cloud(20, 2, 36, 3,
                                                      scale=0.3)
    fea = cloud(21, 2, 140, 4)
    got = ops.query_and_group_dilate(
        t(xyz), t(ctr), t(fea), nsample=8,
        generator=torch.Generator().manual_seed(3))
    slots = torch.randperm(16, generator=torch.Generator().manual_seed(3))[:8]
    idx = np.asarray(jops.knn(j(xyz), j(ctr), 16))[:, :, slots.numpy()]
    want = jops.query_and_group_dilate(j(xyz), j(ctr), j(fea), j(idx),
                                       nsample=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        ops.query_and_group_dilate(t(xyz), t(ctr), nsample=8)


def test_group_all_matches_jax():
    xyz, fea = cloud(22, 2, 30, 3), cloud(23, 2, 30, 4)
    for f, use_xyz in ((fea, True), (fea, False), (None, True)):
        got = ops.group_all(t(xyz), None if f is None else t(f),
                            use_xyz=use_xyz)
        want = jops.group_all(j(xyz), None if f is None else j(f),
                              use_xyz=use_xyz)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- sampling
@pytest.mark.parametrize("n,m", [(30, 8), (256, 64)])
def test_furthest_point_sample_matches_jax(n, m):
    xyz = cloud(24 + n, 2, n, 3)
    got = ops.furthest_point_sample(t(xyz), m)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.furthest_point_sample(j(xyz), m)))
    np.testing.assert_array_equal(got.numpy(),
                                  np_fps(xyz.astype(np.float64), m))


def test_gather_points_matches_jax():
    fea = cloud(25, 2, 40, 5)
    idx = np.random.RandomState(26).randint(0, 40, (2, 12)).astype(np.int32)
    np.testing.assert_array_equal(
        ops.gather_points(t(fea), t(idx)).numpy(),
        np.asarray(jops.gather_points(j(fea), j(idx))))


# ----------------------------------------------------------- interpolation
@pytest.mark.parametrize("ties", [False, True])
def test_three_nn_and_interpolate_match_jax(ties):
    unknown = cloud(27, 2, 90, 3)
    known = duplicated(28, 2, 20, 3) if ties else cloud(28, 2, 40, 3)
    dist, idx = ops.three_nn(t(unknown), t(known))
    j_dist, j_idx = jops.three_nn(j(unknown), j(known))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    assert rel(dist, j_dist) <= TOL
    if ties:
        # the nearest point and its duplicate: the lower index first
        np.testing.assert_array_equal(idx.numpy()[..., 1],
                                      idx.numpy()[..., 0] + 20)
    w = ops.three_interpolate_weights(dist)
    assert rel(w, jops.three_interpolate_weights(j_dist)) <= TOL
    fea = cloud(29, 2, known.shape[1], 6)
    assert rel(ops.interpolate(t(fea), idx, w),
               jops.interpolate(j(fea), j_idx,
                                jops.three_interpolate_weights(j_dist))) <= TOL


# --------------------------------------------------- labelstat, distribute
def test_labelstat_matches_jax():
    rng = np.random.RandomState(30)
    xyz = rng.rand(2, 80, 3).astype(np.float32)
    ctr = rng.rand(2, 20, 3).astype(np.float32)
    stat = rng.randint(0, 4, size=(2, 80, 5)).astype(np.int32)
    got = ops.labelstat_ballrange(0.3, t(xyz), t(ctr), t(stat))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.labelstat_ballrange(0.3, j(xyz),
                                                         j(ctr), j(stat))))
    idx = rng.randint(0, 80, size=(2, 20, 6)).astype(np.int32)
    np.testing.assert_array_equal(
        ops.labelstat_idx(t(stat), t(idx)).numpy(),
        np.asarray(jops.labelstat_idx(j(stat), j(idx))))
    for got, want in zip(
            ops.labelstat_and_ballquery(0.3, 4, t(xyz), t(ctr), t(stat)),
            jops.labelstat_and_ballquery(0.3, 4, j(xyz), j(ctr), j(stat))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_feature_distribute_and_gather_match_jax():
    max_xyz, xyz = cloud(31, 2, 25, 3), cloud(32, 2, 60, 3)
    got = ops.feature_distribute(t(max_xyz), t(xyz))
    want = jops.feature_distribute(j(max_xyz), j(xyz))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    fea = cloud(33, 2, 25, 7)
    np.testing.assert_array_equal(
        ops.feature_gather(t(fea), got).numpy(),
        np.asarray(jops.feature_gather(j(fea), want)))


# ------------------------------------------------------------------- edges
@pytest.mark.parametrize("C,k", [(3, 4), (16, 6), (32, 10)])
def test_edge_features_match_jax_exactly(C, k):
    x, pc = cloud(34 + C, 2, 96, C), cloud(35, 2, 96, 3)
    np.testing.assert_array_equal(
        ops.edge_features(t(x), k).numpy(),
        np.asarray(jops.edge_features(j(x), k)))
    for got, want in zip(ops.edge_features_xyz(t(x), t(pc), k),
                         jops.edge_features_xyz(j(x), j(pc), k)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("C,k", [(3, 5), (24, 8)])
def test_neighbor_features_match_jax_exactly(C, k):
    x = cloud(36 + C, 2, 80, C)
    idx, nbr = ops.neighbor_features(t(x), k)
    j_idx, j_nbr = j_neighbor_features(j(x), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(j_nbr))


def test_neighbor_features_beyond_the_kernel_width_take_the_plain_route():
    """k + 1 > MAX_K: the plain version, as JAX's XLA route."""
    x = cloud(40, 1, 140, 8)
    idx, nbr = ops.neighbor_features(t(x), 128)
    j_idx, j_nbr = j_neighbor_features(j(x), 128)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(j_nbr))
    np.testing.assert_array_equal(ops.edges.neighbor_idx(t(x), 128).numpy(),
                                  np.asarray(j_idx))


def test_the_library_on_cpu_tensors_launches_nothing():
    _lib.LAUNCHES.clear()
    xyz = t(cloud(37, 2, 64, 3))
    ops.group_xyz(xyz, nsample=4)
    ops.neighbor_features(t(cloud(38, 2, 64, 8)), 3)
    ops.edge_features(t(cloud(39, 2, 64, 8)), 3)
    assert sum(_lib.LAUNCHES.values()) == 0
    assert _lib._lib is None
