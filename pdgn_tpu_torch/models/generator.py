"""Progressive point-cloud generator (port of pdgn_tpu/models/generator.py).

A 128-d noise vector is lifted to a 32 x base_points feature cloud and
pushed through four bilateral upsampling blocks, each doubling the point
count and emitting a coordinate head (256/512/1024/2048 points at full
width). The forward is the JAX package's decomposed one, op for op: the
edge tensors are never materialised, the stage input stays an
``(xs, ec)`` pair, and the heavy per-stage work runs in three kernels
(``ops/kernels``: edge head, slot stats, bilateral tail).

The module tree and parameter layouts are the reference's
(models/PDGNet_v2.py:439-877), so ``state_dict`` keys are exactly the torch
prefixes of ``convert_ckpt.generator_rules()`` and a reference ``G_model``
loads with ``load_state_dict`` once the ``module.`` prefix is stripped. The
window conv's output channels run in block order: the weight, bias and
batch norm are permuted on the parameter side in ``forward``.

Left out against the JAX module: the padded-batch mask branches, sync BN
(``axis_name``) and the bf16 compute policy. v2 always applies softmax.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from pdgn_tpu_torch.models.layers import (MLP, BatchNorm, BatchNormFold,
                                          TorchDense, leaky_relu)
from pdgn_tpu_torch.ops.edges import neighbor_idx
from pdgn_tpu_torch.ops.grouping import grouping
from pdgn_tpu_torch.ops.kernels.bilateral_tail import edge_conv_tail
from pdgn_tpu_torch.ops.kernels.edge_head import edge_conv_head
from pdgn_tpu_torch.ops.kernels.slot_stats import slot_moment_stats

_EPS = 1e-5


def _block_channel_perm(four_fin: int) -> Tuple[int, ...]:
    """Reference -> block channel permutation of the window-conv output:
    block channel ``p = j*2Fin + c`` carries reference channel
    ``2c + j``. ``perm[p]`` is the reference channel."""
    two_fin = four_fin // 2
    return tuple(2 * (p % two_fin) + (p // two_fin) for p in range(four_fin))


def _point_pixel_shuffle(y: torch.Tensor) -> torch.Tensor:
    """``(B, N, 2F) -> (B, 2N, F)``: channel ``f*2 + j`` of point ``n``
    becomes point ``j*N + n`` (reference models/PDGNet_v2.py:583-585)."""
    B, N, two_fout = y.shape
    r = y.reshape(B, N, two_fout // 2, 2).permute(0, 3, 1, 2)
    return r.reshape(B, 2 * N, two_fout // 2)


class _Conv(nn.Module):
    """A raw conv parameter pair ``weight (out, in, 1, W)``, ``bias``."""

    def __init__(self, out_ch: int, in_ch: int, width: int):
        super().__init__()
        self.fan_in = in_ch * width
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 1, width))
        self.bias = nn.Parameter(torch.empty(out_ch))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        bound = 1.0 / self.fan_in ** 0.5
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)


class _ConvBN(nn.Module):
    """The reference ``conv2dbr`` merge conv: ``conv`` + ``bn``."""

    def __init__(self, out_ch: int, in_ch: int, width: int):
        super().__init__()
        self.conv = _Conv(out_ch, in_ch, width)
        self.bn = BatchNorm(out_ch)

    def merge_kernel(self) -> torch.Tensor:
        """``(2F, 2C, 1, 2k)`` -> the slot-major ``(2k*2C, 2F)`` kernel."""
        w = self.conv.weight
        two_f, two_c, _, two_k = w.shape
        return w[:, :, 0, :].permute(2, 1, 0).reshape(two_k * two_c, two_f)


def _window_kernel(conv: _Conv, perm: torch.Tensor):
    """``(4Fin, 2C, 1, W)`` -> HWIO ``(1, W, 2C, 4Fin)`` in block order."""
    kernel = conv.weight.permute(2, 3, 1, 0)[..., perm]
    return kernel, conv.bias[perm]


class EdgeConv(nn.Module):
    """Plain edge convolution (reference ``edgeConv``,
    models/PDGNet_v2.py:652-670; off the live PDGN path):
    ``(B, N, Fin) -> (B, N, Fout)``.

    A 1x1 conv over the edge features ``[x | nbr - x]`` of the feature-space
    graph (:func:`neighbor_idx`, the ``knn_topk`` kernel on the card), batch
    norm on batch statistics, ReLU, max over the k neighbours. The conv is
    split as the JAX package's ``_split_1x1``: ``x @ (Wc - Wn) + b`` per
    point plus the gathered ``x @ Wn``, so the ``(B, N, k, 2Fin)`` edge
    tensor never exists. Parameters: ``conv.conv`` (weight ``(Fout, 2Fin,
    1, 1)``, bias) and ``conv.bn``.
    """

    def __init__(self, fin: int, fout: int, k: int):
        super().__init__()
        self.fin, self.fout, self.k = fin, fout, k
        self.conv = _ConvBN(fout, 2 * fin, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel = self.conv.conv.weight[:, :, 0, 0].T       # (2Fin, Fout)
        wc, wn = kernel[:self.fin], kernel[self.fin:]
        point = torch.matmul(x, wc - wn) + self.conv.conv.bias
        nbr = grouping(torch.matmul(x, wn), neighbor_idx(x, self.k))
        e = torch.relu(self.conv.bn(point[:, :, None, :] + nbr))
        return torch.amax(e, dim=2)


class UpsampleEdgeConv(nn.Module):
    """Point-doubling edge convolution (reference ``upsample_edgeConv``,
    models/PDGNet_v2.py:547-588): ``(B, N, Fin) -> (B, 2N, Fout)``."""

    def __init__(self, fin: int, fout: int, k: int):
        super().__init__()
        self.fin, self.fout, self.k = fin, fout, k
        window = k // 2 + 1
        self.conv2 = _ConvBN(2 * fout, 2 * fin, 2 * k)
        self.inte_conv_hk = nn.Sequential(_Conv(4 * fin, 2 * fin, window),
                                          BatchNormFold(4 * fin))
        self.register_buffer(
            "perm", torch.tensor(_block_channel_perm(4 * fin)),
            persistent=False)

    def forward(self, x: torch.Tensor):
        conv_kernel, conv_bias = _window_kernel(self.inte_conv_hk[0],
                                                self.perm)
        merge_kernel = self.conv2.merge_kernel()
        idx, inte_raw, partial, (i_mean, i_var) = edge_conv_head(
            x, conv_kernel, conv_bias, merge_kernel, self.k)[:4]
        i_stats = self.inte_conv_hk[1].fold(i_mean, i_var, self.perm)
        y = edge_conv_tail(partial, inte_raw, None, i_stats, None, None,
                           merge_kernel, self.conv2.conv.bias, self.k)
        y = self.conv2.bn(y)
        return _point_pixel_shuffle(torch.relu(y)), idx


class BilateralUpsampleEdgeConv(nn.Module):
    """Bilaterally-weighted point-doubling edge convolution (reference
    ``bilateral_upsample_edgeConv``, models/PDGNet_v2.py:590-650), taking
    the stage input as the ``(xs, x)`` pair (``xs=None``: plain input)."""

    def __init__(self, fin: int, fout: int, k: int, softmax: bool = True):
        super().__init__()
        self.fin, self.fout, self.k, self.softmax = fin, fout, k, softmax
        window = k // 2 + 1
        self.conv2 = _ConvBN(2 * fout, 2 * fin, 2 * k)
        self.inte_conv_hk = nn.Sequential(_Conv(4 * fin, 2 * fin, window),
                                          BatchNormFold(4 * fin))
        self.conv_fea = nn.Sequential(TorchDense(2 * fin, 16, (1, 1)),
                                      BatchNormFold(16))
        self.conv_xyz = nn.Sequential(TorchDense(6, 16, (1, 1)),
                                      BatchNormFold(16))
        self.conv_all = nn.Sequential(
            TorchDense(16, 64, (1, 1)), BatchNormFold(64), nn.LeakyReLU(0.01),
            TorchDense(64, 2 * fin, (1, 1)), BatchNormFold(2 * fin))
        self.register_buffer(
            "perm", torch.tensor(_block_channel_perm(4 * fin)),
            persistent=False)

    def forward(self, x: torch.Tensor, pc: torch.Tensor,
                xs: Optional[torch.Tensor] = None):
        B, N, _ = x.shape
        C, k = self.fin, self.k
        cx = 0 if xs is None else xs.shape[-1]
        conv_kernel, conv_bias = _window_kernel(self.inte_conv_hk[0],
                                                self.perm)
        merge_kernel = self.conv2.merge_kernel()

        # weight-net projections: e @ W = x @ (Wc - Wn) + gather(src @ Wn);
        # the xs rows of both halves fold into per-batch terms on ppoint
        fk, fb = self.conv_fea[0].kernel, self.conv_fea[0].bias
        xk, xb = self.conv_xyz[0].kernel, self.conv_xyz[0].bias
        cp = pc.shape[-1]
        fwc_full = fk[:C] - fk[C:]
        fwn_full = fk[C:]
        pp_fea = torch.matmul(x, fwc_full[cx:]) + fb
        if xs is not None:
            pb_fea = torch.matmul(xs, fwc_full[:cx] + fwn_full[:cx])
            pp_fea = pp_fea + pb_fea[:, None, :]
        ppoint = torch.cat(
            [pp_fea, torch.matmul(pc, xk[:cp] - xk[cp:]) + xb], dim=-1)
        pcat = torch.cat([torch.matmul(x, fwn_full[cx:]),
                          torch.matmul(pc, xk[cp:])], dim=-1)

        (idx, inte_raw, partial, (i_mean, i_var), wfea, wxyz, fea_stats,
         xyz_stats) = edge_conv_head(x, conv_kernel, conv_bias, merge_kernel,
                                     k, pcat, ppoint, xs=xs)
        i_stats = self.inte_conv_hk[1].fold(i_mean, i_var, self.perm)

        fm, fv = fea_stats
        xm, xv = xyz_stats
        _, _, fsc, fsh = self.conv_fea[1].fold(fm, fv)
        _, _, xsc, xsh = self.conv_xyz[1].fold(xm, xv)
        fs = fsc * torch.rsqrt(fv + _EPS)
        xs_ = xsc * torch.rsqrt(xv + _EPS)
        # normalise + LeakyReLU + gate-multiply in the lane-flat layout
        w_flat = (leaky_relu(wfea * fs.repeat(k) + (fsh - fm * fs).repeat(k))
                  * leaky_relu(wxyz * xs_.repeat(k)
                               + (xsh - xm * xs_).repeat(k)))
        # conv_all1 per slot (16 -> 64) + bn_all1 pooled over the k slots
        c1 = self.conv_all[0]
        h_pre = (torch.matmul(w_flat.reshape(B, N, k, 16), c1.kernel)
                 + c1.bias).reshape(B, N, k * 64)
        cnt = float(B * N * k)
        hs = h_pre.sum(dim=(0, 1)).reshape(k, 64)
        hq = (h_pre * h_pre).sum(dim=(0, 1)).reshape(k, 64)
        m1 = hs.sum(dim=0) / cnt
        v1 = hq.sum(dim=0) / cnt - m1 * m1
        _, _, sc1, bi1 = self.conv_all[1].fold(m1, v1)
        s1 = sc1 * torch.rsqrt(v1 + _EPS)
        h = leaky_relu(h_pre * s1.repeat(k) + (bi1 - m1 * s1).repeat(k))

        # bn_all2's statistics from the slot moments of h through the
        # linear identity: E[y] = m.W + b, E[y^2] = W^T S W + 2b(m.W) + b^2
        c2 = self.conv_all[3]
        kf, bf = c2.kernel, c2.bias
        s_vec, s_mat = slot_moment_stats(h, k)
        rows = float(B * N * k)
        m_x = s_vec / rows
        s_mat = s_mat / rows
        mk = torch.matmul(m_x, kf)
        m2 = mk + bf
        ex2 = (kf * torch.matmul(s_mat, kf)).sum(dim=0) + 2.0 * bf * mk + bf * bf
        v2 = torch.clamp(ex2 - m2 * m2, min=0.0)
        w2_stats = self.conv_all[4].fold(m2, v2)

        y = edge_conv_tail(partial, inte_raw, h, i_stats, (kf, bf), w2_stats,
                           merge_kernel, self.conv2.conv.bias, k,
                           softmax=self.softmax)
        y = self.conv2.bn(y)
        return _point_pixel_shuffle(torch.relu(y)), idx


def _fc(fin: int, fout: int) -> nn.Sequential:
    """Reference ``fc``: Linear, BN, LeakyReLU, Linear, BN (indices 0-4)."""
    return nn.Sequential(TorchDense(fin, fin), BatchNorm(fin),
                         nn.LeakyReLU(0.01), TorchDense(fin, fout),
                         BatchNorm(fout))


def _global_branch(fc: nn.Sequential, g_fc: Optional[nn.Sequential],
                   pooled: torch.Tensor):
    """Max-pooled features -> ``xs (B, Fout)`` and ``g (B, 512)`` or None
    (reference ``fc`` + ``g_fc``, models/PDGNet_v2.py:682-694)."""
    xs = leaky_relu(fc[1](fc[0](pooled)))
    xs = leaky_relu(fc[4](fc[3](xs)))
    if g_fc is None:
        return xs, None
    return xs, leaky_relu(g_fc[1](g_fc[0](xs)))


class BilateralBlock(nn.Module):
    """One progressive stage (reference ``bilateral_block_l{1..4}``,
    models/PDGNet_v2.py:672-818). Stage 1 uses :class:`UpsampleEdgeConv`
    wrapped as in the reference (``upsample_cov.0`` edge conv,
    ``upsample_cov.1`` its BN); stages 2-4 the bilateral variant and
    ``bn_uc``. Stage 4 has no ``g_fc``."""

    def __init__(self, fin: int, fout: int, k: int, bilateral: bool = True,
                 with_g: bool = True, softmax: bool = True):
        super().__init__()
        self.bilateral = bilateral
        self.fc = _fc(fin, fout)
        self.g_fc = (nn.Sequential(TorchDense(fout, 512), BatchNorm(512))
                     if with_g else None)
        if bilateral:
            self.upsample_cov = BilateralUpsampleEdgeConv(fin, fout, k,
                                                          softmax)
            self.bn_uc = BatchNorm(fout)
        else:
            self.upsample_cov = nn.Sequential(
                UpsampleEdgeConv(fin, fout, k), BatchNorm(fout),
                nn.LeakyReLU(0.01))

    def forward(self, x: torch.Tensor, pc: Optional[torch.Tensor] = None,
                xs_in: Optional[torch.Tensor] = None):
        """``x``: per-point features (the whole stage input when ``xs_in``
        is None). Returns ``(xs_new, g, ec_new, idx)``: the pair whose
        concat is the reference's ``x_out``, ``g`` (or None) and the stage's
        kNN graph."""
        pooled = torch.amax(x, dim=1)
        if xs_in is not None:
            pooled = torch.cat([xs_in, pooled], dim=-1)
        xs, g = _global_branch(self.fc, self.g_fc, pooled)
        if self.bilateral:
            x_ec, idx = self.upsample_cov(x, pc, xs=xs_in)
            bn = self.bn_uc
        else:
            x_ec, idx = self.upsample_cov[0](x)
            bn = self.upsample_cov[1]
        return xs, g, leaky_relu(bn(x_ec)), idx


class PairMLP(MLP):
    """:class:`MLP` whose first layer is decomposed against a ``(g, ec)``
    pair (the per-batch half is one per-batch GEMM; the concat never
    exists)."""

    def forward(self, g: torch.Tensor, ec: torch.Tensor) -> torch.Tensor:
        dense = [m for m in self if isinstance(m, TorchDense)]
        kernel = dense[0].kernel
        cg = g.shape[-1]
        pb = torch.matmul(g, kernel[:cg]) + dense[0].bias
        x = leaky_relu(torch.matmul(ec, kernel[cg:]) + pb[:, None, :])
        for d in dense[1:-1]:
            x = leaky_relu(d(x))
        return dense[-1](x)


class PointGenerator(nn.Module):
    """128-d noise -> four point clouds (reference ``PointGenerator``,
    models/PDGNet_v2.py:820-877). ``base_points`` < 128 shrinks every stage
    proportionally (small test configurations); it must exceed
    ``num_k // 2``."""

    def __init__(self, num_point: int = 2048, num_k: int = 20,
                 softmax: bool = True, base_points: int = 128,
                 noise_dim: int = 128):
        super().__init__()
        self.num_point = num_point
        self.base_points = base_points
        self.noise_dim = noise_dim
        k = num_k // 2
        self.fc1 = nn.Sequential(TorchDense(noise_dim, 32 * base_points),
                                 BatchNorm(32 * base_points))
        self.bilateral1 = BilateralBlock(32, 32, k, bilateral=False)
        self.bilateral2 = BilateralBlock(64, 64, k, softmax=softmax)
        self.bilateral3 = BilateralBlock(128, 128, k, softmax=softmax)
        self.bilateral4 = BilateralBlock(256, 256, k, with_g=False,
                                         softmax=softmax)
        for i, cin in enumerate((512 + 32, 512 + 64, 512 + 128, 256 + 256)):
            self.add_module(f"mlp{i + 1}", PairMLP(cin, (256, 64, 3)))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Re-draw every parameter (torch default init) from ``generator``."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, z: torch.Tensor, return_graphs: bool = False):
        """``z (B, noise_dim)`` -> the four clouds ``(B, 2^i * base, 3)``;
        with ``return_graphs`` also the four stages' kNN graphs."""
        B = z.shape[0]
        x = leaky_relu(self.fc1[1](self.fc1[0](z)))
        # torch view(B, 32, base) is (channel, point): to (B, N, C)
        x = x.reshape(B, 32, self.base_points).transpose(1, 2)
        xs1, g1, ec1, i1 = self.bilateral1(x)
        x1s = self.mlp1(g1, ec1)
        xs2, g2, ec2, i2 = self.bilateral2(ec1, x1s, xs_in=xs1)
        x2s = self.mlp2(g2, ec2)
        xs3, g3, ec3, i3 = self.bilateral3(ec2, x2s, xs_in=xs2)
        x3s = self.mlp3(g3, ec3)
        xs4, _, ec4, i4 = self.bilateral4(ec3, x3s, xs_in=xs3)
        x4s = self.mlp4(xs4, ec4)
        clouds = (x1s, x2s, x3s, x4s)
        if return_graphs:
            return clouds, [i1, i2, i3, i4]
        return clouds
