"""The port's evaluation suite against the JAX package on the same clouds:
Chamfer, the plain approxmatch (value and gradient), the fused CD+EMD
kernel's plain route against the Pallas kernel in interpret mode, the tiled
pairwise matrices, the MMD/COV/1-NNA reductions, JSD, the whole suite and
the golden fixture. Inputs are made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import rel, t

from pdgn_tpu import eval as jeval
from pdgn_tpu.losses.chamfer import chamfer_cd as j_chamfer_cd
from pdgn_tpu.losses.chamfer import dist_chamfer as j_dist_chamfer
from pdgn_tpu.losses.emd import match_cost as j_match_cost
from pdgn_tpu.ops.pallas import fused_cd_emd
from pdgn_tpu_torch import eval as teval
from pdgn_tpu_torch.losses.chamfer import chamfer_cd, dist_chamfer
from pdgn_tpu_torch.losses.emd import emd_approx, match_cost
from pdgn_tpu_torch.ops.kernels import _lib
from pdgn_tpu_torch.ops.kernels.emd_cd import emd_cd
from tests.test_eval import np_cd
from tests.test_golden_metrics import GOLDEN, _fixture
from tests.test_losses import np_approxmatch

CPU = dict(device="cpu")


def clouds(seed, *shape, scale=0.3):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def test_chamfer_matches_jax():
    a, b = clouds(0, 3, 64, 3), clouds(1, 3, 80, 3)
    got = dist_chamfer(t(a), t(b))
    want = j_dist_chamfer(jnp.asarray(a), jnp.asarray(b))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert rel(g, np.asarray(w)) <= 1e-5
    b = clouds(2, 3, 64, 3)
    got = chamfer_cd(t(a), t(b))
    want = np.asarray(j_chamfer_cd(jnp.asarray(a), jnp.asarray(b)))
    assert rel(got, want) <= 1e-5
    # and the float64 oracle
    assert rel(got[1], np_cd(a[1].astype(np.float64),
                             b[1].astype(np.float64))) <= 1e-5


@pytest.mark.parametrize("n,m", [(128, 128), (96, 48)])
def test_match_cost_value_and_gradient_match_jax(n, m):
    a, b = clouds(3, 2, n, 3), clouds(4, 2, m, 3)
    x1 = t(a).requires_grad_(True)
    x2 = t(b).requires_grad_(True)
    cost = match_cost(x1, x2)
    # a non-uniform cotangent exercises the per-pair scaling
    w = torch.tensor([1.0, -0.5])
    (cost * w).sum().backward()
    jcost, jgrad = jax.value_and_grad(
        lambda p, q: jnp.sum(j_match_cost(p, q) * jnp.asarray([1.0, -0.5])),
        argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    want = np.asarray(j_match_cost(jnp.asarray(a), jnp.asarray(b)))
    assert rel(cost, want) <= 1e-5
    assert rel(x1.grad, np.asarray(jgrad[0])) <= 1e-4
    assert rel(x2.grad, np.asarray(jgrad[1])) <= 1e-4
    # the float64 oracle (the integer multipliers when n != m)
    want64, g1, _ = np_approxmatch(a[0].astype(np.float64),
                                   b[0].astype(np.float64))
    assert rel(cost[0], want64) <= 2e-4
    assert rel(x1.grad[0], g1) <= 2e-3


def test_emd_approx_normalises_and_needs_equal_sizes():
    a, b = clouds(5, 2, 32, 3), clouds(6, 2, 32, 3)
    np.testing.assert_allclose(emd_approx(t(a), t(b)).numpy(),
                               match_cost(t(a), t(b)).numpy() / 32.0)
    with pytest.raises(ValueError):
        emd_approx(t(a), t(clouds(7, 2, 16, 3)))


@pytest.fixture(scope="module")
def pallas_case():
    """3 aligned pairs of 256 points through the Pallas kernel (interpret
    mode), as tests/test_pallas_kernels.py runs it."""
    rng = np.random.RandomState(0)
    x1 = (rng.randn(3, 256, 3) * 0.4).astype(np.float32)
    x2 = (rng.randn(3, 256, 3) * 0.4).astype(np.float32)
    cd, cost = fused_cd_emd(jnp.asarray(x1), jnp.asarray(x2), interpret=True)
    return x1, x2, np.asarray(cd), np.asarray(cost)


def test_emd_cd_plain_route_matches_the_pallas_kernel(pallas_case):
    x1, x2, cd_j, cost_j = pallas_case
    _lib.LAUNCHES.clear()
    cd, cost = emd_cd(t(x1), t(x2))          # every pair of the two sets
    assert cd.shape == (3, 3) and cost.shape == (3, 3)
    assert sum(_lib.LAUNCHES.values()) == 0  # the CPU runs the plain version
    assert rel(torch.diagonal(cd), cd_j) <= 1e-5
    # the kernel and the plain path take distances two ways (direct
    # differences, norm expansion); at level -4^7 an ulp of d2 moves K
    # by ~2e-3 relative: the JAX package's own kernel-vs-exact limit
    assert rel(torch.diagonal(cost), cost_j) <= 2e-3
    # off the diagonal: the plain path pair by pair
    for s in range(3):
        for r in range(3):
            assert rel(cd[s, r], np.asarray(j_chamfer_cd(
                jnp.asarray(x1[s:s + 1]), jnp.asarray(x2[r:r + 1])))) <= 1e-5
    want = np.asarray(j_match_cost(jnp.asarray(x1[2:3]),
                                   jnp.asarray(x2[0:1])))
    assert rel(cost[2, 0], want) <= 1e-5


def test_emd_cd_identical_pairs_and_shape_checks(pallas_case):
    x1 = t(pallas_case[0])
    cd, cost = emd_cd(x1, x1)
    np.testing.assert_allclose(torch.diagonal(cd).numpy(), 0.0, atol=1e-5)
    assert bool((torch.diagonal(cost) / 256.0 < 1e-3).all())
    with pytest.raises(ValueError):
        emd_cd(torch.zeros(1, 256, 3), torch.zeros(1, 512, 3))
    with pytest.raises(ValueError):
        emd_cd(torch.zeros(1, 256, 2), torch.zeros(1, 256, 2))
    with pytest.raises(TypeError):
        emd_cd(torch.zeros(1, 64, 3, dtype=torch.float64),
               torch.zeros(1, 64, 3, dtype=torch.float64))


@pytest.fixture(scope="module")
def cloud_sets():
    rng = np.random.RandomState(7)
    sample = (rng.randn(6, 24, 3) * 0.2).astype(np.float32)
    ref = (rng.randn(6, 24, 3) * 0.2).astype(np.float32)
    return sample, ref


@pytest.mark.parametrize("symmetric", [False, True])
def test_pairwise_cd_emd_matches_jax(cloud_sets, symmetric):
    sample, ref = cloud_sets
    if symmetric:
        ref = sample
    _lib.LAUNCHES.clear()
    cd, emd = teval.pairwise_cd_emd(sample, ref, tile=4, symmetric=symmetric,
                                    **CPU)
    cd_j, emd_j = jeval.pairwise_cd_emd(sample, ref, tile=4,
                                        symmetric=symmetric)
    assert cd.shape == emd.shape == (6, 6)
    assert cd.dtype == np.float32
    off = ~np.eye(6, dtype=bool) if symmetric else np.ones((6, 6), bool)
    assert rel(cd[off], cd_j[off]) <= 1e-5
    assert rel(emd[off], emd_j[off]) <= 1e-5
    if symmetric:
        np.testing.assert_array_equal(cd, cd.T)
        np.testing.assert_array_equal(emd, emd.T)
        # a cloud against itself: the norm expansion leaves D_ii at a few
        # ulp of |x|^2 (BLAS rounds x.x otherwise than the row norms), whose
        # square root is a distance of ~1e-4; the 1-NN classifier never
        # reads the diagonal
        assert np.abs(np.diag(cd)).max() <= 1e-6
        assert np.abs(np.diag(emd)).max() <= 1e-4
    assert sum(_lib.LAUNCHES.values()) == 0


def test_pairwise_cd_emd_rectangular_and_cd_only(cloud_sets, tmp_path):
    sample, ref = cloud_sets
    cd, emd = teval.pairwise_cd_emd(sample[:5], ref, tile=4, **CPU)
    cd_j, emd_j = jeval.pairwise_cd_emd(sample[:5], ref, tile=4)
    assert cd.shape == (5, 6)
    assert rel(cd, cd_j) <= 1e-5 and rel(emd, emd_j) <= 1e-5
    cd2, emd2 = teval.pairwise_cd_emd(sample[:5], ref, tile=4,
                                      with_emd=False, **CPU)
    assert rel(cd2, cd_j) <= 1e-5
    assert not emd2.any()
    # the row tiles over a group of one rank: the one-process matrices
    import torch.distributed as dist

    from pdgn_tpu_torch.parallel import make_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            world_size=1, rank=0)
    try:
        cd3, emd3 = teval.pairwise_cd_emd(sample[:5], ref, tile=4,
                                          mesh=make_mesh("cpu"), **CPU)
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(cd3, cd)
    np.testing.assert_array_equal(emd3, emd)


def test_reductions_equal_jax():
    """MMD/COV and the 1-NN classifier on the same matrices: equal, the
    transposed off-diagonal block and the stable tie order included."""
    rng = np.random.RandomState(11)
    n = 9
    Mrs = rng.rand(n, n).astype(np.float32)
    Mrr = rng.rand(n, n).astype(np.float32)
    Mss = rng.rand(n, n).astype(np.float32)
    Mrs[2, :] = Mrs[3, :]                  # ties in the argmin / argsort
    Mrs[:, 4] = Mrs[:, 5]
    assert teval.lgan_mmd_cov(Mrs.T) == jeval.lgan_mmd_cov(Mrs.T)
    assert teval.lgan_mmd_cov(Mrs) == jeval.lgan_mmd_cov(Mrs)
    for k in (1, 3):
        for sqrt in (False, True):
            assert (teval.knn_classifier(Mrr, Mrs, Mss, k, sqrt=sqrt)
                    == jeval.knn_classifier(Mrr, Mrs, Mss, k, sqrt=sqrt))


def test_jsd_pieces_match_jax():
    g, sp = teval.unit_cube_grid_point_cloud(28, True)
    g_j, sp_j = jeval.unit_cube_grid_point_cloud(28, True)
    np.testing.assert_array_equal(g, g_j)
    assert sp == sp_j
    a = np.clip(clouds(12, 5, 400, 3, scale=0.2), -0.49, 0.49)
    b = np.clip(clouds(13, 5, 400, 3, scale=0.25), -0.49, 0.49)
    for x in (a, b):
        ent, counts = teval.entropy_of_occupancy_grid(x, 28, True, **CPU)
        ent_j, counts_j = jeval.entropy_of_occupancy_grid(x, 28, True)
        np.testing.assert_array_equal(counts, counts_j)
        assert ent == pytest.approx(ent_j, rel=1e-12)
    jsd = teval.jsd_between_point_cloud_sets(a, b, **CPU)
    jsd_j = jeval.jsd_between_point_cloud_sets(a, b)
    assert abs(jsd - jsd_j) <= 1e-6 * abs(jsd_j)
    P, Q = counts, counts_j + np.arange(len(counts_j)) % 3
    assert (teval.jensen_shannon_divergence(P, Q)
            == jeval.jensen_shannon_divergence(P, Q))


EXACT = ("lgan_cov-CD", "lgan_cov-EMD", "1-NN-CD-acc_t", "1-NN-CD-acc_f",
         "1-NN-CD-acc", "1-NN-EMD-acc_t", "1-NN-EMD-acc_f", "1-NN-EMD-acc")


def assert_suites_agree(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if k in EXACT:
            assert got[k] == w, (k, got[k], w)
        else:
            assert abs(got[k] - w) <= 1e-4 * abs(w), (k, got[k], w)


@pytest.mark.parametrize("mode", ["full", "fast_symmetric", "cd_only"])
def test_compute_all_metrics_matches_jax(mode):
    gen = clouds(14, 7, 48, 3, scale=0.22)
    ref = clouds(15, 7, 48, 3, scale=0.25)
    kw = {"full": {}, "fast_symmetric": {"fast_symmetric": True},
          "cd_only": {"with_emd": False}}[mode]
    got = teval.compute_all_metrics(gen, ref, tile=3, **kw, **CPU)
    want = jeval.compute_all_metrics(gen, ref, tile=3, **kw)
    assert_suites_agree(got, want)
    assert ("lgan_mmd-EMD" in got) == (mode != "cd_only")


def test_golden_metrics_through_the_port():
    gen, ref = _fixture()
    res = teval.compute_all_metrics(gen, ref, tile=8, **CPU)
    res["jsd"] = teval.jsd_between_point_cloud_sets(gen, ref, **CPU)
    for k, want in GOLDEN.items():
        got = float(res[k])
        assert abs(got - want) <= max(2e-3, 5e-3 * abs(want)), (k, got, want)


def test_paired_emd_cd_matches_jax(cloud_sets):
    sample, ref = cloud_sets
    for reduced in (True, False):
        got = teval.EMD_CD(sample, ref, batch_size=4, reduced=reduced, **CPU)
        want = jeval.EMD_CD(sample, ref, batch_size=4, reduced=reduced)
        for k in ("MMD-CD", "MMD-EMD"):
            assert rel(np.asarray(got[k]), np.asarray(want[k])) <= 1e-5


def test_metrics_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device works")
    a = clouds(16, 2, 16, 3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        teval.compute_all_metrics(a, a)
