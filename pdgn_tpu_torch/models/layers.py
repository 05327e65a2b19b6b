"""Shared building blocks (port of pdgn_tpu/models/layers.py:91-557),
channel-last like the JAX package.

Parameters keep the reference torch layouts and names (``weight`` as
``(out, in, *trailing)``, BatchNorm's ``weight/bias/running_mean/
running_var/num_batches_tracked``), so a reference ``state_dict`` loads
directly; the forward computes in the JAX package's ``(in, out)`` form.

BatchNorm follows the reference's quirk that the generator is never put in
eval mode: it ALWAYS normalises with the current batch's statistics.
``training`` decides only whether the running averages move (eps 1e-5,
momentum 0.1, biased batch variance, as the JAX ``_BNStatsVars``); this is
why the port does not use ``nn.BatchNorm1d``, whose running variance takes
the unbiased estimate.

A layer's ``dtype`` (``None`` or ``torch.bfloat16``) is the JAX package's
compute dtype: ``TorchDense`` computes as flax's ``Dense(dtype=...)``
(operands and bias cast, the product rounded, then the bias added in that
dtype), ``BatchNorm`` takes its statistics from the fp32 upcast and casts
its output. Parameters and statistics stay fp32.

Every batch-norm site has an ``axis`` (``None``, or the model's
:class:`~pdgn_tpu_torch.parallel.sync_bn.DataAxis`, given by
``parallel.set_group``): with one, the moment sums and row counts are the
global batch's over the ranks (the JAX package's sharded-batch statistics).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from pdgn_tpu_torch.parallel.sync_bn import (cross_replica_moments,
                                             global_moments)


@functools.lru_cache(maxsize=None)
def _bf16_value(v: float) -> float:
    """``v`` rounded to bf16 (round to nearest even), as a Python float."""
    return float(torch.tensor(v, dtype=torch.bfloat16))


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    """torch-default LeakyReLU (slope 0.01). On a bf16 tensor the slope is
    rounded to bf16 and the product once, as JAX multiplies a bf16
    activation by a weakly typed scalar (0.01 -> 0.010009765625)."""
    if x.dtype == torch.bfloat16:
        negative_slope = _bf16_value(negative_slope)
    return torch.nn.functional.leaky_relu(x, negative_slope)


def upcast(t: torch.Tensor) -> torch.Tensor:
    """``t`` in fp32 when it is stored in bf16, else as it is (fp32, and the
    float64 of the checks' arbiters)."""
    return t.float() if t.dtype == torch.bfloat16 else t


class _MatmulF32(torch.autograd.Function):
    """One bf16 product with an fp32 result on the card, differentiable as
    the CPU path's product of the upcasts is: each operand's gradient the
    fp32 product of the fp32 cotangent and the other operand's upcast,
    rounded to the operand's bf16."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        out = torch.mm(a.reshape(-1, a.shape[-1]), b,
                       out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.reshape(-1, g.shape[-1])
        da = db = None
        if ctx.needs_input_grad[0]:
            da = (g @ b.float().T).to(a.dtype).reshape(a.shape)
        if ctx.needs_input_grad[1]:
            db = (a.reshape(-1, a.shape[-1]).float().T @ g).to(b.dtype)
        return da, db


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of bf16 operands accumulated and returned in fp32 (XLA's
    ``preferred_element_type=float32``; bf16 products are exact in fp32):
    on the card one bf16 product with an fp32 result (cuBLAS, fp32
    accumulation), on the CPU the product of the fp32 upcasts; both
    differentiable alike. fp32 and float64 operands as they are."""
    if a.dtype == b.dtype == torch.bfloat16 and a.is_cuda and b.dim() == 2:
        return _MatmulF32.apply(a, b)
    return torch.matmul(upcast(a), upcast(b))


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 and back in fp32: a product operand's rounding
    in the plain versions of the bf16 backward kernels."""
    return t.to(torch.bfloat16).float()


def cast(dtype: Optional[torch.dtype], t: torch.Tensor) -> torch.Tensor:
    """``t`` in the compute dtype (the JAX package's ``_cast``/``_to``);
    ``dtype=None`` leaves it as it is."""
    return t if dtype is None else t.to(dtype)


class TorchDense(nn.Module):
    """``nn.Linear``-compatible dense layer over the last axis.

    ``trailing`` gives the weight's extra unit axes so the same layer holds
    a ``Conv1d`` (``(1,)``) or 1x1 ``Conv2d`` (``(1, 1)``) weight under the
    reference's name. torch default init: ``U(-1/sqrt(fan_in), ...)`` for
    weight and bias (kaiming-uniform with a=sqrt(5)).
    """

    def __init__(self, in_features: int, out_features: int,
                 trailing: Tuple[int, ...] = (),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, *trailing))
        self.bias = nn.Parameter(torch.empty(out_features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        bound = 1.0 / math.sqrt(self.in_features)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    @property
    def kernel(self) -> torch.Tensor:
        """The JAX-layout ``(in, out)`` kernel."""
        return self.weight.reshape(self.out_features, self.in_features).T

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return torch.matmul(x, self.kernel) + self.bias
        dt = self.dtype
        return (matmul_f32(x.to(dt), self.kernel.to(dt)).to(dt)
                + self.bias.to(dt))


class BatchNorm(nn.Module):
    """Torch-semantics batch norm over all axes but the last, always on
    batch statistics (see the module docstring)."""

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))
        self.axis = None    # parallel.sync_bn.DataAxis: global statistics

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)
            self.num_batches_tracked.zero_()

    def update_running(self, mean: torch.Tensor, var: torch.Tensor,
                       perm: Optional[torch.Tensor] = None) -> None:
        """Fold one batch's (mean, biased var) into the running averages
        when training. ``perm`` maps the statistics' channel order to the
        stored (reference) order: ``stored[perm[p]] <- stat[p]``."""
        if not self.training:
            return
        m = 1.0 - self.momentum
        with torch.no_grad():
            if perm is None:
                self.running_mean.copy_(m * self.running_mean
                                        + self.momentum * mean)
                self.running_var.copy_(m * self.running_var
                                       + self.momentum * var)
            else:
                self.running_mean[perm] = (m * self.running_mean[perm]
                                           + self.momentum * mean)
                self.running_var[perm] = (m * self.running_var[perm]
                                          + self.momentum * var)
            self.num_batches_tracked += 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = upcast(x)
        mean, var = cross_replica_moments(x, self.axis)
        # clamp at 0: the E[x^2] - E[x]^2 form can go slightly negative
        var = torch.clamp(var, min=0.0)
        self.update_running(mean.detach(), var.detach())
        s = self.weight * torch.rsqrt(var + self.eps)
        return cast(self.dtype, x * s + (self.bias - mean * s))


class BatchNormFold(BatchNorm):
    """A :class:`BatchNorm` whose statistics are computed elsewhere (a
    kernel's sums, the linear second-moment identity). ``fold`` updates the
    running averages and returns ``(mean, var, scale, bias)`` for the
    caller to fold into its own pass; ``perm`` selects the channel order of
    the statistics (the window conv's block order)."""

    def fold(self, mean: torch.Tensor, var: torch.Tensor,
             perm: Optional[torch.Tensor] = None):
        self.update_running(mean.detach(), var.detach(), perm)
        if perm is None:
            return mean, var, self.weight, self.bias
        return mean, var, self.weight[perm], self.bias[perm]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        raise TypeError("BatchNormFold takes precomputed statistics: "
                        "call fold(mean, var)")


class DenseDBR(nn.Sequential):
    """Dense + Dropout + BN + ReLU, or LeakyReLU with ``negative_slope``
    (port of ``DenseDBR``, pdgn_tpu/models/layers.py:521; the reference's
    ``fcdbr``, utils/nn_utils.py:26-41). Weights at indices 0 (dense) and
    2 (BN); dropout runs in training mode only (JAX's ``deterministic=not
    training``)."""

    def __init__(self, in_features: int, features: int,
                 drop_rate: float = 0.5,
                 negative_slope: Optional[float] = None):
        super().__init__(TorchDense(in_features, features),
                         nn.Dropout(drop_rate), BatchNorm(features))
        self.negative_slope = negative_slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self[2](self[1](self[0](x)))
        if self.negative_slope is None:
            return torch.relu(x)
        return leaky_relu(x, self.negative_slope)


class MLP(nn.Sequential):
    """Dense layers with LeakyReLU between, no BN (the reference coordinate
    heads ``mlp1..4``: Conv1d(1x1) + LeakyReLU pairs, then a final Conv1d).
    Weights sit at indices 0, 2, 4, ... as in the reference Sequential."""

    def __init__(self, in_features: int, features: Sequence[int],
                 trailing: Tuple[int, ...] = (1,),
                 dtype: Optional[torch.dtype] = None):
        layers = []
        fin = in_features
        for i, f in enumerate(features):
            if i:
                layers.append(nn.LeakyReLU(0.01))
            layers.append(TorchDense(fin, f, trailing, dtype))
            fin = f
        super().__init__(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dense = [m for m in self if isinstance(m, TorchDense)]
        for d in dense[:-1]:
            x = leaky_relu(d(x))
        return dense[-1](x)


def linear_bn_stats(x: torch.Tensor, kernel: torch.Tensor,
                    bias: torch.Tensor, axis=None):
    """Batch mean and (biased) variance of ``y = x @ kernel + bias`` from
    the fp32 moments of ``x`` (port of ``linear_bn_stats``, pdgn_tpu/models/
    layers.py:304): ``E[y] = m.W + b``, ``E[y^2] = W^T S W + 2b(m.W) +
    b^2`` with ``S = E[x x^T]``. These are the statistics of the unrounded
    product, whatever dtype ``y`` is stored in. With an ``axis`` the sums
    of ``x`` and ``x^T x`` are the global batch's."""
    xf = upcast(x).reshape(-1, x.shape[-1])
    (s_vec, s_mat), rows = global_moments(
        axis, (xf.sum(dim=0), torch.matmul(xf.T, xf)), xf.shape[0])
    rows = float(rows)
    m_x = s_vec / rows
    s_mat = s_mat / rows
    mk = torch.matmul(m_x, kernel)
    mean = mk + bias
    ex2 = ((kernel * torch.matmul(s_mat, kernel)).sum(dim=0)
           + 2.0 * bias * mk + bias * bias)
    return mean, torch.clamp(ex2 - mean * mean, min=0.0)


# DenseBR's widest input whose statistics come from linear_bn_stats
# (pdgn_tpu/models/layers.py:461); wider inputs take them from y
LINEAR_STATS_MAX_IN = 128


def dense_br(dense: TorchDense, bn: BatchNorm, x: torch.Tensor,
             negative_slope: float = 0.01) -> torch.Tensor:
    """Dense + BN + LeakyReLU (port of ``DenseBR``, the reference
    ``conv1dbr``). fp32: the JAX block's linear second-moment statistics
    are the same batch statistics, taken here over ``y`` itself. A bf16
    ``dense`` stores ``y`` in bf16, where the two definitions differ by
    ``y``'s rounding: the statistics are then the JAX block's, from
    :func:`linear_bn_stats` for inputs at most ``LINEAR_STATS_MAX_IN``
    wide, else from the upcast of ``y`` (its ``BatchNorm``)."""
    if dense.dtype is None or x.shape[-1] > LINEAR_STATS_MAX_IN:
        return leaky_relu(bn(dense(x)), negative_slope)
    y = dense(x)
    mean, var = linear_bn_stats(x, dense.kernel, dense.bias, bn.axis)
    bn.update_running(mean.detach(), var.detach())
    s = bn.weight * torch.rsqrt(var + bn.eps)
    y = cast(dense.dtype, upcast(y) * s + (bn.bias - mean * s))
    return leaky_relu(y, negative_slope)


def dense_br_pool(dense: TorchDense, bn: BatchNorm, x: torch.Tensor,
                  negative_slope: float = 0.01) -> torch.Tensor:
    """:func:`dense_br` + max over the point axis: ``(B, N, C) -> (B, F)``
    (port of ``DenseBRPool``, which reduces the GEMM output before the
    monotone BN affine and LeakyReLU: the same function, the same winning
    element). A bf16 ``dense`` takes the JAX block's order: the statistics
    of the upcast bf16 ``y``, then per channel its maximum (its minimum
    where the BN scale is negative), the affine and the LeakyReLU in fp32;
    the output is fp32 either way."""
    if dense.dtype is None:
        return torch.amax(dense_br(dense, bn, x, negative_slope), dim=-2)
    yf = upcast(dense(x))
    axes = tuple(range(yf.dim() - 1))
    n = 1
    for a in axes:
        n *= yf.shape[a]
    (s1, s2), n = global_moments(
        bn.axis, (yf.sum(dim=axes), (yf * yf).sum(dim=axes)), n)
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    bn.update_running(mean.detach(), var.detach())
    s = bn.weight * torch.rsqrt(var + bn.eps)
    t = bn.bias - mean * s
    pooled = torch.where(s > 0, torch.amax(yf, dim=-2),
                         torch.amin(yf, dim=-2))
    return leaky_relu(pooled * s + t, negative_slope)
