"""Shared helpers of the ``test_torch_*`` files: the same numpy inputs go
through the JAX package and its PyTorch port."""

import numpy as np
import pytest
import torch


def rel(a, b) -> float:
    """max |a - b| / max |b| (arrays or tensors)."""
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else b
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def t(x) -> torch.Tensor:
    """numpy / jax array -> contiguous fp32 (or int) CPU tensor."""
    return torch.from_numpy(np.array(x))


def perturb_bn(params, batch_stats, rng):
    """Random BN affine parameters and running statistics (identity init
    would hide channel-order mistakes)."""
    import jax

    def walk(p, s):
        out_p, out_s = {}, {}
        for key, v in p.items():
            if isinstance(v, dict):
                out_p[key], sub_s = walk(v, s.get(key, {}) if s else {})
                if sub_s:
                    out_s[key] = sub_s
            else:
                out_p[key] = v
        if "scale" in p and "bias" in p and s and "mean" in s:
            n = np.asarray(p["scale"]).shape
            out_p["scale"] = (1.0 + 0.2 * rng.randn(*n)).astype(np.float32)
            out_p["bias"] = (0.2 * rng.randn(*n)).astype(np.float32)
            out_s["mean"] = (0.1 * rng.randn(*n)).astype(np.float32)
            out_s["var"] = (0.5 + rng.rand(*n)).astype(np.float32)
        return out_p, out_s

    params = jax.tree.map(np.asarray, params)
    batch_stats = jax.tree.map(np.asarray, batch_stats)
    return walk(params, batch_stats)


def head_inputs(seed, B=2, N=48, C=16, cx=0, k=6, two_f=12):
    rng = np.random.RandomState(seed)
    cf = C + cx
    window = k // 2 + 1
    four_fin = 4 * cf
    f = np.float32
    return dict(
        x=(rng.randn(B, N, C) * 0.5).astype(f),
        xs=(rng.randn(B, cx) * 0.5).astype(f) if cx else None,
        conv_kernel=(rng.randn(1, window, 2 * cf, four_fin) * 0.1).astype(f),
        conv_bias=(rng.randn(four_fin) * 0.1).astype(f),
        merge_kernel=(rng.randn(2 * k * 2 * cf, two_f) * 0.05).astype(f),
        pcat=(rng.randn(B, N, 32) * 0.5).astype(f),
        ppoint=(rng.randn(B, N, 32) * 0.5).astype(f),
        k=k)


def tail_inputs(seed, B=2, N=40, k=6, fin=8, two_f=12, H=64):
    rng = np.random.RandomState(seed)
    hk = k // 2
    four_fin, two_fin = 4 * fin, 2 * fin
    f = np.float32

    def stats(n):
        return ((rng.randn(n) * 0.1).astype(f), (rng.rand(n) + 0.5).astype(f),
                (rng.rand(n) + 0.5).astype(f), (rng.randn(n) * 0.1).astype(f))

    return dict(
        partial=rng.randn(B, N, two_f).astype(f),
        inte=rng.randn(B, N, hk * four_fin).astype(f),
        h=(rng.randn(B, N, k * H) * 0.5).astype(f),
        inte_stats=stats(four_fin),
        w2=((rng.randn(H, two_fin) * 0.3).astype(f),
            (rng.randn(two_fin) * 0.1).astype(f)),
        w2_stats=stats(two_fin),
        merge_kernel=(rng.randn(2 * k * two_fin, two_f) * 0.05).astype(f),
        merge_bias=(rng.randn(two_f) * 0.1).astype(f),
        k=k)


def bf16_ulps(a, b) -> float:
    """The largest difference of two bf16-valued arrays in bf16 ulps (2^(e -
    7) at binary exponent e) of max(|a|, |b|, max|b| / 256), elementwise:
    values near 0 after cancellation count at 1/256 of the largest, whose
    sums' rounding they carry."""
    a = a.detach().float().cpu().numpy() if isinstance(a, torch.Tensor) else a
    b = b.detach().float().cpu().numpy() if isinstance(b, torch.Tensor) else b
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)),
                     max(np.abs(b).max() * 2.0 ** -8, 1e-30))
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    return float((np.abs(a - b) / ulp).max())


def bf16_pair(a):
    """numpy fp32 -> the same values rounded to bf16, as a torch tensor and
    as a JAX array."""
    import jax.numpy as jnp

    tb = torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16()
    return tb, jnp.asarray(tb.float().numpy()).astype(jnp.bfloat16)


def perturbed_state(model, seed):
    """``model``'s weights drawn (torch default init) from ``seed``, with
    random batch-norm parameters and running statistics, as a state dict
    (identity init would hide channel-order mistakes)."""
    model.reset_parameters(torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    sd = model.state_dict()
    for key, v in sd.items():
        if key.endswith((".weight", ".running_var")) and v.dim() == 1:
            sd[key] = t((1.0 + 0.2 * rng.randn(v.numel())).astype(np.float32))
        elif key.endswith((".bias", ".running_mean")) and v.dim() == 1:
            sd[key] = t((0.2 * rng.randn(v.numel())).astype(np.float32))
    return sd


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread for a module's tests (autouse where
    imported): under the suite's parallel workers, torch's thread pools
    oversubscribe the cores, and a CPU train step that takes a second alone
    took 100 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
