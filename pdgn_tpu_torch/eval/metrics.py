"""The generative point-cloud metric suite: MMD / COV / 1-NNA on CD and EMD,
plus JSD (port of pdgn_tpu/eval/metrics.py, reference
evaluation/evaluation_metrics.py).

The ``(N_sample, N_ref)`` CD and EMD matrices come from
:func:`pairwise_cd_emd`: tiles of ``tile`` clouds on each side go to the
fused kernel ``ops/kernels/emd_cd.py`` (one launch a tile, every pair of the
tile in it), results stay on the device and come back once. The reductions
follow the reference exactly, including the quirk that ``knn`` receives the
``(N_s, N_r)`` sample-vs-ref matrix where an ``(N_r, N_s)`` block is
expected, which is shape-consistent only because the test phase has
``N_s == N_r``. JSD counts occupancy on a 28^3 grid clipped to the unit
sphere, with an exact nearest-center argmin in place of sklearn's KD-tree,
and cross-checks the two JSD formulas. The numpy reductions are copies of
the JAX package's (the port imports nothing of it).
"""

from __future__ import annotations

import collections
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from scipy.stats import entropy

from pdgn_tpu_torch.losses.chamfer import chamfer_cd
from pdgn_tpu_torch.losses.emd import match_cost
from pdgn_tpu_torch.ops.kernels.emd_cd import emd_cd
from pdgn_tpu_torch.utils.misc import resolve_device

_WINDOW = 16             # tiles in flight before the host waits
_PLAIN_BYTES = 1 << 28   # per chunk of the plain CD-only pairs and of JSD


def _as_device(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _cd_only(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """CD of every pair (the ``with_emd=False`` path: plain, as the JAX
    package's), in chunks of pairs that bound the distance matrices."""
    S, n, _ = a.shape
    R = b.shape[0]
    pa = a[:, None].expand(S, R, n, 3).reshape(S * R, n, 3)
    pb = b[None, :].expand(S, R, n, 3).reshape(S * R, n, 3)
    step = max(1, _PLAIN_BYTES // (4 * n * n))
    out = [chamfer_cd(pa[p:p + step], pb[p:p + step])
           for p in range(0, S * R, step)]
    return torch.cat(out).reshape(S, R)


def pairwise_cd_emd(sample_pcs, ref_pcs, tile: int = 8,
                    with_emd: bool = True, verbose: bool = False,
                    symmetric: bool = False, mesh=None,
                    device: str = "cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Full ``(N_sample, N_ref)`` CD and EMD matrices (reference
    ``_pairwise_EMD_CD_``, evaluation_metrics.py:85-121), in
    ``(tile, tile)`` blocks of pairs on ``device``.

    The last row and column of tiles hold what is left: the kernel takes
    any number of clouds per side and computes each pair alone, so the JAX
    package's zero padding (a static shape for its compiled tile program)
    would only add pairs to cut away. ``symmetric=True`` (a set against
    itself) computes the upper triangle of tiles and mirrors it: CD is
    exactly symmetric, approxmatch EMD only to ~0.1%, so it is an opt-in
    speed-up. EMD is zeros when ``with_emd=False``.

    ``mesh`` (a :class:`~pdgn_tpu_torch.parallel.mesh.Mesh`, on every rank
    of its group with the same clouds) distributes the rows of tiles: rank
    r computes tile rows r, r + W, ... on ``mesh.device``, and one sum over
    the ranks of the zero-filled matrices gives every rank all of them,
    equal to one process's.
    """
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")
    dev = resolve_device(device if mesh is None else mesh.device)
    sp = _as_device(sample_pcs, dev)
    rp = _as_device(ref_pcs, dev)
    Ns, N = sp.shape[0], sp.shape[1]
    Nr = rp.shape[0]
    cd = torch.zeros(Ns, Nr, device=dev)
    emd = torch.zeros_like(cd)
    n_row, n_col = -(-Ns // tile), -(-Nr // tile)
    # results stay on the device; the host only waits once _WINDOW tiles are
    # queued, on the oldest of them (no synchronisation per tile)
    pending = collections.deque()
    for i in range(n_row):
        if mesh is not None and i % mesh.world != mesh.rank:
            continue
        srow = sp[i * tile:(i + 1) * tile]
        for j in range(n_col):
            if symmetric and j < i:
                continue
            rcol = rp[j * tile:(j + 1) * tile]
            block = (slice(i * tile, (i + 1) * tile),
                     slice(j * tile, (j + 1) * tile))
            if with_emd:
                c, cost = emd_cd(srow, rcol)
                emd[block] = cost / float(N)
            else:
                c = _cd_only(srow, rcol)
            cd[block] = c
            if dev.type == "cuda":
                ev = torch.cuda.Event()
                ev.record()
                pending.append(ev)
                if len(pending) > _WINDOW:
                    pending.popleft().synchronize()
        if verbose:
            print(f"pairwise tile row {i + 1}/{n_row}", flush=True)
    if mesh is not None:
        cd, emd = mesh.sum_tensors([cd, emd])
    cd = cd.cpu().numpy()
    emd = emd.cpu().numpy()
    if symmetric:
        upper = np.triu_indices(Ns, 1)
        cd[(upper[1], upper[0])] = cd[upper]
        emd[(upper[1], upper[0])] = emd[upper]
    return cd, emd


# ---------------------------------------------------------------- reductions
def lgan_mmd_cov(all_dist: np.ndarray) -> Dict[str, float]:
    """MMD / COV from a (N_sample, N_ref) matrix (reference :157-169)."""
    N_ref = all_dist.shape[1]
    min_val_fromsmp = all_dist.min(axis=1)
    min_idx = all_dist.argmin(axis=1)
    min_val = all_dist.min(axis=0)
    return {
        "lgan_mmd": float(min_val.mean()),
        "lgan_cov": float(len(np.unique(min_idx)) / float(N_ref)),
        "lgan_mmd_smp": float(min_val_fromsmp.mean()),
    }


def knn_classifier(Mxx: np.ndarray, Mxy: np.ndarray, Myy: np.ndarray,
                   k: int, sqrt: bool = False) -> Dict[str, float]:
    """Leave-one-out k-NN two-sample classifier (reference ``knn``,
    :125-154). ``x`` rows (label 1) are the reference set, ``y`` (label 0)
    the samples; the off-diagonal blocks are ``Mxy`` and ``Mxy.T``."""
    n0, n1 = Mxx.shape[0], Myy.shape[0]
    label = np.concatenate([np.ones(n0), np.zeros(n1)])
    M = np.block([[Mxx, Mxy], [Mxy.T, Myy]]).astype(np.float64)
    if sqrt:
        M = np.sqrt(np.abs(M))
    np.fill_diagonal(M, np.inf)
    # only the set of k nearest per column matters (majority vote): the
    # stable argsort keeps the lowest-index tie order up to n = 4096;
    # past that argpartition (the same set but at exact float64 ties)
    n = M.shape[0]
    if n <= 4096 or k + 1 >= n:
        idx = np.argsort(M, axis=0, kind="stable")[:k]
    else:
        idx = np.argpartition(M, k - 1, axis=0)[:k]
    count = label[idx].sum(axis=0)
    pred = (count >= (float(k) / 2)).astype(np.float64)

    tp = float((pred * label).sum())
    fp = float((pred * (1 - label)).sum())
    fn = float(((1 - pred) * label).sum())
    tn = float(((1 - pred) * (1 - label)).sum())
    return {
        "tp": tp, "fp": fp, "fn": fn, "tn": tn,
        "precision": tp / (tp + fp + 1e-10),
        "recall": tp / (tp + fn + 1e-10),
        "acc_t": tp / (tp + fn + 1e-10),
        "acc_f": tn / (tn + fp + 1e-10),
        "acc": float((pred == label).mean()),
    }


def EMD_CD(sample_pcs, ref_pcs, batch_size: int, reduced: bool = True,
           device: str = "cuda") -> Dict[str, np.ndarray]:
    """Paired (row-wise) CD and EMD (reference ``EMD_CD``, :48-82), through
    the plain ``chamfer_cd`` and ``match_cost`` as the JAX package's."""
    dev = resolve_device(device)
    sample_pcs = _as_device(sample_pcs, dev)
    ref_pcs = _as_device(ref_pcs, dev)
    if sample_pcs.shape[0] != ref_pcs.shape[0]:
        raise ValueError("EMD_CD pairs rows: the sets need equal sizes")
    N = sample_pcs.shape[0]
    cd_lst, emd_lst = [], []
    with torch.no_grad():
        for s in range(0, N, batch_size):
            a = sample_pcs[s:s + batch_size]
            b = ref_pcs[s:s + batch_size]
            cd_lst.append(chamfer_cd(a, b).cpu().numpy())
            emd = match_cost(a, b) / float(a.shape[1])
            emd_lst.append(emd.cpu().numpy())
    cd = np.concatenate(cd_lst)
    emd = np.concatenate(emd_lst)
    if reduced:
        return {"MMD-CD": cd.mean(), "MMD-EMD": emd.mean()}
    return {"MMD-CD": cd, "MMD-EMD": emd}


def compute_all_metrics(sample_pcs, ref_pcs,
                        batch_size: Optional[int] = None, tile: int = 8,
                        verbose: bool = False, fast_symmetric: bool = False,
                        mesh=None, with_emd: bool = True,
                        device: str = "cuda") -> Dict[str, float]:
    """The full suite (reference ``compute_all_metrics``, :172-200).

    ``batch_size`` is accepted for parity (tiling replaces it).
    ``fast_symmetric`` mirrors the within-set matrices from one triangle
    (perturbs 1-NNA by ~0.1%: EMD is not exactly symmetric).
    ``with_emd=False`` skips the EMD family; its CD is the plain path's.
    ``mesh`` distributes each matrix's rows (:func:`pairwise_cd_emd`); the
    reductions then run on every rank.
    """
    results: Dict[str, float] = {}
    kw = dict(tile=tile, verbose=verbose, with_emd=with_emd, mesh=mesh,
              device=device)
    M_rs_cd, M_rs_emd = pairwise_cd_emd(sample_pcs, ref_pcs, **kw)

    fams = (("CD", M_rs_cd), ("EMD", M_rs_emd)) if with_emd \
        else (("CD", M_rs_cd),)
    for name, M in fams:
        res = lgan_mmd_cov(M.T)
        results.update({f"{k}-{name}": v for k, v in res.items()})

    M_rr_cd, M_rr_emd = pairwise_cd_emd(ref_pcs, ref_pcs,
                                        symmetric=fast_symmetric, **kw)
    M_ss_cd, M_ss_emd = pairwise_cd_emd(sample_pcs, sample_pcs,
                                        symmetric=fast_symmetric, **kw)

    one_nn_cd = knn_classifier(M_rr_cd, M_rs_cd, M_ss_cd, 1, sqrt=False)
    results.update({f"1-NN-CD-{k}": v for k, v in one_nn_cd.items()
                    if "acc" in k})
    if with_emd:
        one_nn_emd = knn_classifier(M_rr_emd, M_rs_emd, M_ss_emd, 1,
                                    sqrt=False)
        results.update({f"1-NN-EMD-{k}": v for k, v in one_nn_emd.items()
                        if "acc" in k})
    return results


# ----------------------------------------------------------------------- JSD
def unit_cube_grid_point_cloud(resolution: int, clip_sphere: bool = False
                               ) -> Tuple[np.ndarray, float]:
    """Cell centers of a resolution^3 grid in the unit cube
    (reference :206-224)."""
    spacing = 1.0 / float(resolution - 1)
    coords = np.arange(resolution, dtype=np.float32) * spacing - 0.5
    grid = np.stack(np.meshgrid(coords, coords, coords, indexing="ij"),
                    axis=-1).astype(np.float32)
    if clip_sphere:
        grid = grid.reshape(-1, 3)
        grid = grid[np.linalg.norm(grid, axis=1) <= 0.5]
    return grid, spacing


def _nearest_center(points: torch.Tensor,
                    centers: torch.Tensor) -> torch.Tensor:
    """``argmin_j ||p_i - c_j||`` for every point ``(B, P, 3) -> (B, P)``
    int64: the fp32 norm expansion ``(|p|^2 - 2 p.c) + |c|^2`` (TF32 off),
    lowest index on ties; chunked over clouds to bound the distances."""
    B, P, _ = points.shape
    c2 = torch.sum(centers * centers, dim=-1)
    step = max(1, _PLAIN_BYTES // (4 * P * centers.shape[0]))
    out = []
    for s in range(0, B, step):
        p = points[s:s + step]
        d = (torch.sum(p * p, dim=-1, keepdim=True)
             - 2.0 * torch.matmul(p, centers.T)) + c2
        out.append(torch.argmin(d, dim=-1))
    return torch.cat(out)


def entropy_of_occupancy_grid(pclouds: np.ndarray, grid_resolution: int,
                              in_sphere: bool = False, verbose: bool = False,
                              device: str = "cuda"
                              ) -> Tuple[float, np.ndarray]:
    """Occupancy-grid entropy and per-cell point counts (reference
    :241-280), with an exact nearest-center argmin on ``device``."""
    epsilon = 10e-4
    bound = 0.5 + epsilon
    if abs(np.max(pclouds)) > bound or abs(np.min(pclouds)) > bound:
        if verbose:
            warnings.warn("Point-clouds are not in unit cube.")
    if in_sphere and np.max(np.sqrt(np.sum(pclouds ** 2, axis=2))) > bound:
        if verbose:
            warnings.warn("Point-clouds are not in unit sphere.")

    grid_coordinates, _ = unit_cube_grid_point_cloud(grid_resolution,
                                                     in_sphere)
    grid_coordinates = grid_coordinates.reshape(-1, 3)
    dev = resolve_device(device)
    n_cells = len(grid_coordinates)
    with torch.no_grad():
        idx = _nearest_center(_as_device(pclouds, dev),
                             _as_device(grid_coordinates, dev)).cpu().numpy()
    grid_counters = np.bincount(idx.ravel(), minlength=n_cells).astype(
        np.float64)
    # per-cell occupancy across clouds: each cloud counts once per cell
    occupied = np.zeros((len(pclouds), n_cells), dtype=bool)
    occupied[np.arange(len(pclouds))[:, None], idx] = True
    grid_bernoulli_rvars = occupied.sum(axis=0).astype(np.float64)

    # Bernoulli entropy per cell, 0 log 0 = 0
    n = float(len(pclouds))
    p = grid_bernoulli_rvars / n
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = np.where(p > 0, -p * np.log(p), 0.0) + np.where(
            p < 1, -(1.0 - p) * np.log1p(-p), 0.0)
    acc_entropy = float(np.sum(np.where(grid_bernoulli_rvars > 0, terms, 0.0)))
    return acc_entropy / n_cells, grid_counters


def _jsdiv(P: np.ndarray, Q: np.ndarray) -> float:
    """The second JSD formula, the run-time cross-check (reference
    :305-321)."""

    def _kldiv(A, B):
        idx = np.logical_and(A > 0, B > 0)
        a, b = A[idx], B[idx]
        return float(np.sum(a * np.log2(a / b)))

    P_ = P / np.sum(P)
    Q_ = Q / np.sum(Q)
    M = 0.5 * (P_ + Q_)
    return 0.5 * (_kldiv(P_, M) + _kldiv(Q_, M))


def jensen_shannon_divergence(P: np.ndarray, Q: np.ndarray) -> float:
    """Entropy-form JSD with the reference's dual-computation warning
    (reference :283-302)."""
    if np.any(P < 0) or np.any(Q < 0):
        raise ValueError("Negative values.")
    if len(P) != len(Q):
        raise ValueError("Non equal size.")
    P_ = P / np.sum(P)
    Q_ = Q / np.sum(Q)
    e1 = entropy(P_, base=2)
    e2 = entropy(Q_, base=2)
    e_sum = entropy((P_ + Q_) / 2.0, base=2)
    res = e_sum - ((e1 + e2) / 2.0)
    res2 = _jsdiv(P_, Q_)
    if not np.allclose(res, res2, atol=10e-5, rtol=0):
        warnings.warn("Numerical values of two JSD methods don't agree.")
    return float(res)


def jsd_between_point_cloud_sets(sample_pcs: np.ndarray, ref_pcs: np.ndarray,
                                 resolution: int = 28,
                                 device: str = "cuda") -> float:
    """JSD between two cloud sets (reference :227-238)."""
    in_unit_sphere = True
    sample_grid_var = entropy_of_occupancy_grid(
        sample_pcs, resolution, in_unit_sphere, device=device)[1]
    ref_grid_var = entropy_of_occupancy_grid(
        ref_pcs, resolution, in_unit_sphere, device=device)[1]
    return jensen_shannon_divergence(sample_grid_var, ref_grid_var)
