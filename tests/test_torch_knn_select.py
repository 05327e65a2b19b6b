"""A lane-by-lane model of ``csrc/knn.cu``'s warp selection, held against
``topk_ascending_idx`` on the CPU.

The kernel cannot run here, so its selection is modelled step for step in
numpy: a warp's sorted list of (distance, index) keys in registers (slots
lane*KP .. lane*KP + KP-1 in the KP registers of a lane), candidates
offered 32 at a time, one a lane, a ``__ballot_sync`` filter against the
K-th key, each survivor inserted in lane order (ballots count the keys
before it; the slots behind it move up one register within a lane, and a
lane's first takes the previous lane's last by ``__shfl_up_sync``; a
survivor pushed past slot K-1 by an earlier one of its batch lands in
slots that are never read), then the K-th key broadcast again. When KP is
a power of two the empty list first takes KP*32 candidates at once and
sorts them by the kernel's bitonic network in registers. The direct
path (C <= 4) offers rows in index order, 32 a batch (the fill: rows
lane*KP + r of the first KP batches); the norm path (C > 4) offers each
128-row tile from its registers, lane l holding rows 4l .. 4l+3, so a batch
is rows 4l + e (the fill: the first tile's batches e < KP). The split
path (a query's N cut into parts, the first
part's warp merging the others' lists by the same filter) is modelled too.
Inputs are full of exact ties (integer grid coordinates, duplicated
points), so the tie order, the lower index first, is pinned exactly.
"""

import numpy as np
import pytest
import torch

from pdgn_tpu_torch.ops.kernels.knn import sqdist
from pdgn_tpu_torch.ops.knn import topk_ascending_idx

INT_MAX = 2 ** 31 - 1
LANES = np.arange(32)


def key_less(d, i, e, j):
    """(distance, index) order, elementwise: the kernel's ``key_less``."""
    return (d < e) | ((d == e) & (i < j))


def ballot(pred):
    """The lanes' predicate as a 32-bit mask (bit l = lane l)."""
    return int(np.sum(np.asarray(pred, np.int64) << LANES))


class WarpList:
    """One warp's list: ``d[r, lane]``, ``i[r, lane]``, slot
    ``lane*KP + r``."""

    def __init__(self, K):
        self.K = K
        self.KP = (K + 31) // 32
        self.d = np.full((self.KP, 32), np.inf, np.float32)
        self.i = np.full((self.KP, 32), INT_MAX, np.int64)
        self.kd, self.ki = np.float32(np.inf), INT_MAX

    def insert(self, v, j):
        pos = sum(bin(ballot(key_less(self.d[r], self.i[r], v, j))).count("1")
                  for r in range(self.KP))
        # __shfl_up_sync by 1 of the last register: lane l reads lane l - 1
        last = self.KP - 1
        pd = np.concatenate([self.d[last][:1], self.d[last][:-1]])
        pi = np.concatenate([self.i[last][:1], self.i[last][:-1]])
        for r in range(self.KP - 1, -1, -1):
            ud = self.d[r - 1] if r > 0 else pd
            ui = self.i[r - 1] if r > 0 else pi
            p = LANES * self.KP + r
            self.d[r] = np.where(p > pos, ud, np.where(p == pos, v, self.d[r]))
            self.i[r] = np.where(p > pos, ui, np.where(p == pos, j, self.i[r]))

    def offer(self, v, j):
        """``v``, ``j``: one candidate a lane (32 each)."""
        m = ballot(key_less(v, j, self.kd, self.ki))
        if not m:
            return
        while m:
            lane = (m & -m).bit_length() - 1
            m &= m - 1
            self.insert(v[lane], j[lane])
        r, lane = (self.K - 1) % self.KP, (self.K - 1) // self.KP
        self.kd, self.ki = self.d[r][lane], self.i[r][lane]

    def fill_sorted(self, v, j):
        """``v``, ``j`` ``(KP, 32)``: candidate (v[r, l], j[r, l]) fills
        slot l*KP + r; then the kernel's bitonic network (flip form, each
        compare-exchange leaving the smaller key in the lower slot, the
        partner of another lane read by ``__shfl_xor_sync``)."""
        KP = self.KP
        self.d, self.i = v.astype(np.float32).copy(), j.copy()
        size = 2
        while size <= KP * 32:
            stride = size >> 1
            while stride:
                flip = size - 1 if stride == size >> 1 else stride
                lx = flip // KP
                nd, ni = self.d.copy(), self.i.copy()
                for r in range(KP):
                    rr = r ^ (flip & (KP - 1))
                    pd, pi = self.d[rr][LANES ^ lx], self.i[rr][LANES ^ lx]
                    p = LANES * KP + r
                    keep = (p < (p ^ flip)) == key_less(self.d[r], self.i[r],
                                                        pd, pi)
                    nd[r] = np.where(keep, self.d[r], pd)
                    ni[r] = np.where(keep, self.i[r], pi)
                self.d, self.i = nd, ni
                stride >>= 1
            size <<= 1
        r, lane = (self.K - 1) % KP, (self.K - 1) // KP
        self.kd, self.ki = self.d[r][lane], self.i[r][lane]

    def slots(self, a):
        """``a[r, lane]`` in slot order."""
        return a.T.reshape(-1)

    def indices(self):
        return self.slots(self.i)[:self.K]


def _rows(d, j, end):
    live = j < end
    v = np.where(live, d[np.minimum(j, d.shape[0] - 1)], np.inf)
    return v.astype(np.float32), np.where(live, j, INT_MAX)


def _offer_rows(wl, d, j):
    wl.offer(*_rows(d, j, d.shape[0]))


def _fills(K):
    return (K + 31) // 32 in (1, 2, 4)


def select_row(d, K, split=1, norm=False):
    """The kernel's selection of one query's distance row ``d (N,)``: the
    direct path's 32-row chunks in ascending index, cut into ``split``
    parts, the first part's list merging the others' in part order; or
    (``norm``) the norm path's 128-row tiles, batch e of a tile rows
    4 lane + e."""
    N = d.shape[0]
    if norm:
        wl = WarpList(K)
        for j0 in range(0, N, 128):
            e0 = 0
            if j0 == 0 and _fills(K):
                e0 = wl.KP
                wl.fill_sorted(*_rows(d, np.stack(
                    [4 * LANES + e for e in range(e0)]), N))
            for e in range(e0, 4):
                _offer_rows(wl, d, j0 + 4 * LANES + e)
        return wl.indices()
    chunks = (N + 31) // 32
    lists = []
    for part in range(split):
        wl = WarpList(K)
        c, c1 = part * chunks // split, (part + 1) * chunks // split
        if _fills(K):
            wl.fill_sorted(*_rows(d, np.stack(
                [c * 32 + LANES * wl.KP + r for r in range(wl.KP)]),
                min(c1 * 32, N)))
            c += wl.KP
        for c in range(c, c1):
            _offer_rows(wl, d, c * 32 + LANES)
        lists.append(wl)
    head = lists[0]
    for other in lists[1:]:
        # staged in shared memory by slot, read back 32 slots at a time
        sd, si = other.slots(other.d), other.slots(other.i)
        for r in range(head.KP):
            p = r * 32 + LANES
            live = p < K
            head.offer(np.where(live, sd[p], np.inf).astype(np.float32),
                       np.where(live, si[p], INT_MAX))
    return head.indices()


def _tied_cloud(rng, n):
    """Integer grid points (many equal distances), every point twice."""
    x = rng.randint(-3, 4, size=(1, n, 3)).astype(np.float32)
    x[:, 1::2] = x[:, 0::2]
    return torch.from_numpy(x)


@pytest.mark.parametrize("norm", [False, True], ids=["direct", "norm"])
@pytest.mark.parametrize("k", [1, 11, 20, 64, 128])
def test_warp_selection_model_matches_topk_ascending(k, norm):
    rng = np.random.RandomState(k)
    db = _tied_cloud(rng, 300)
    q = torch.cat([db[:, :6], torch.from_numpy(
        rng.randint(-3, 4, size=(1, 4, 3)).astype(np.float32))], dim=1)
    d = sqdist(q, db)[0].numpy()
    want = topk_ascending_idx(sqdist(q, db), k)[0].numpy()
    for row in range(d.shape[0]):
        np.testing.assert_array_equal(select_row(d[row], k, norm=norm),
                                      want[row], err_msg=f"query {row}")


@pytest.mark.parametrize("k,split", [(20, 2), (64, 4), (128, 8)])
def test_warp_selection_model_split_merge_matches(k, split):
    """N cut across the warps of a block, their lists merged: the same
    indices, ties included."""
    rng = np.random.RandomState(100 + k)
    db = _tied_cloud(rng, 1030)
    q = db[:, 10:14]
    d = sqdist(q, db)[0].numpy()
    want = topk_ascending_idx(sqdist(q, db), k)[0].numpy()
    for row in range(d.shape[0]):
        np.testing.assert_array_equal(select_row(d[row], k, split),
                                      want[row], err_msg=f"query {row}")


def test_warp_selection_model_all_equal_distances():
    """Every distance equal: the K lowest indices, in order."""
    d = np.zeros(500, np.float32)
    np.testing.assert_array_equal(select_row(d, 100, 4), np.arange(100))
