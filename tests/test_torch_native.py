"""The port's native CPU oracles (``pdgn_tpu_torch.native``) against the JAX
package's (``pdgn_tpu.native``) and against the port's own torch code.

Both libraries compile the same algorithms with the same flags (g++ -O3
-std=c++17, nothing more), so on the same numpy inputs the indices are
equal and the floats bit-equal. Against the port's torch code, as
tests/test_native.py holds the JAX package's: ``ops.knn`` (indices equal;
its ``return_dist`` route, the norm expansion, d² atol 1e-4),
``losses.chamfer.dist_chamfer`` (atol 1e-4, its two outputs in the other
order), ``losses.emd.match_cost`` (rtol 2e-4) and
``ops.furthest_point_sample`` (equal).

Cases: the JAX test's (2, 48, 3) / (2, 32, 3); n < m with m a multiple of n
(16 / 48) and not (20 / 48), which take approxmatch's integer-division
multipliers; a cloud whose every point appears twice (first-seen ties in
kNN and FPS) against a random one. The tests skip only where g++ is
missing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdgn_tpu import native as jax_native
from pdgn_tpu_torch import native
from pdgn_tpu_torch.losses.chamfer import dist_chamfer
from pdgn_tpu_torch.losses.emd import match_cost
from pdgn_tpu_torch.ops import furthest_point_sample, knn

K = 6
FPS_M = 12


def _dup(rng):
    """(2, 48, 3): 24 points, then the same 24 again."""
    u = rng.randn(2, 24, 3).astype(np.float32)
    return np.concatenate([u, u], axis=1)


CASES = {
    "jax_48_32": lambda rng: (rng.randn(2, 48, 3), rng.randn(2, 32, 3)),
    "n16_m48": lambda rng: (rng.randn(2, 16, 3), rng.randn(2, 48, 3)),
    "n20_m48": lambda rng: (rng.randn(2, 20, 3), rng.randn(2, 48, 3)),
    "duplicated": lambda rng: (_dup(rng), rng.randn(2, 32, 3)),
}


@pytest.fixture(autouse=True)
def _compiler():
    if not native.available():
        pytest.skip("g++ not found: the native oracles cannot be built")


@pytest.fixture(params=sorted(CASES))
def clouds(request):
    rng = np.random.RandomState(sorted(CASES).index(request.param))
    a, b = (np.ascontiguousarray(x, np.float32)
            for x in CASES[request.param](rng))
    return a, b


def _bits_equal(ours: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert ours.numpy().dtype == want.dtype
    assert ours.shape == want.shape
    np.testing.assert_array_equal(ours.numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_knnquery(clouds):
    """Centers ``b`` in the database ``a``, and ``a`` in itself."""
    a, b = clouds
    for db, q in ((a, b), (a, a)):
        idx, d2 = native.knnquery_cpu(torch.from_numpy(db),
                                      torch.from_numpy(q), K)
        idx_j, d2_j = jax_native.knnquery_cpu(jnp.asarray(db),
                                              jnp.asarray(q), K)
        assert idx.dtype == torch.int32
        np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
        _bits_equal(d2, d2_j)
        np.testing.assert_array_equal(
            idx.numpy(), knn(torch.from_numpy(db), torch.from_numpy(q),
                             K).numpy())
        _, d2_t = knn(torch.from_numpy(db), torch.from_numpy(q), K,
                      return_dist=True)
        np.testing.assert_allclose(d2.numpy(), d2_t.numpy(), atol=1e-4)
    if a.shape[1] == 48 and np.array_equal(a[:, :24], a[:, 24:]):
        # each point's first two neighbours: itself and its twin, the
        # lower index first
        idx, d2 = native.knnquery_cpu(torch.from_numpy(a),
                                      torch.from_numpy(a), K)
        low = np.arange(48) % 24
        np.testing.assert_array_equal(idx[..., 0].numpy(),
                                      np.broadcast_to(low, (2, 48)))
        np.testing.assert_array_equal(idx[..., 1].numpy(),
                                      np.broadcast_to(low + 24, (2, 48)))
        assert not d2[..., :2].any()


def test_nndistance(clouds):
    a, b = clouds
    dl, dr = native.nndistance_cpu(torch.from_numpy(a), torch.from_numpy(b))
    dl_j, dr_j = jax_native.nndistance_cpu(jnp.asarray(a), jnp.asarray(b))
    _bits_equal(dl, dl_j)
    _bits_equal(dr, dr_j)
    # dist_chamfer(a, b): (min over a for each b point, min over b for
    # each a point)
    to_a, to_b = dist_chamfer(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(dl.numpy(), to_b.numpy(), atol=1e-4)
    np.testing.assert_allclose(dr.numpy(), to_a.numpy(), atol=1e-4)


def test_approxmatch(clouds):
    """``a`` against ``b``, and ``a`` against a reversed, shifted copy (the
    JAX test's pair)."""
    a, b = clouds
    shifted = np.ascontiguousarray(a[:, ::-1] + np.float32(0.05))
    for x, y in ((a, b), (a, shifted)):
        cost = native.approxmatch_cpu(torch.from_numpy(x),
                                      torch.from_numpy(y))
        _bits_equal(cost, jax_native.approxmatch_cpu(jnp.asarray(x),
                                                     jnp.asarray(y)))
        np.testing.assert_allclose(
            cost.numpy(),
            match_cost(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
            rtol=2e-4)


def test_fps(clouds):
    a, b = clouds
    for x in (a, b):
        idx = native.fps_cpu(torch.from_numpy(x), FPS_M)
        assert idx.dtype == torch.int32
        np.testing.assert_array_equal(
            idx.numpy(), np.asarray(jax_native.fps_cpu(jnp.asarray(x),
                                                       FPS_M)))
        np.testing.assert_array_equal(
            idx.numpy(),
            furthest_point_sample(torch.from_numpy(x), FPS_M).numpy())
    if a.shape[1] == 48 and np.array_equal(a[:, :24], a[:, 24:]):
        # a twin is never picked: its distance to the set is 0 once the
        # first of the pair is in
        idx = native.fps_cpu(torch.from_numpy(a), 24).numpy()
        assert (idx < 24).all()
        assert all(len(set(row)) == 24 for row in idx)


@pytest.mark.parametrize("call", ["knnquery", "nndistance", "approxmatch",
                                  "fps"])
def test_refuses_other_devices_and_shapes(call):
    """Any device but the CPU raises (the oracles never move a tensor), and
    so does a cloud that is not (b, n >= 1, 3)."""
    fn = {"knnquery": lambda x: native.knnquery_cpu(x, x, 2),
          "nndistance": lambda x: native.nndistance_cpu(x, x),
          "approxmatch": lambda x: native.approxmatch_cpu(x, x),
          "fps": lambda x: native.fps_cpu(x, 2)}[call]
    with pytest.raises(ValueError, match="CPU functions"):
        fn(torch.zeros(1, 4, 3, device="meta"))
    for shape in ((1, 4, 2), (4, 3), (1, 0, 3)):
        with pytest.raises(ValueError, match="expected"):
            fn(torch.zeros(shape))
