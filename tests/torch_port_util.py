"""Shared helpers of the ``test_torch_*`` files: the same numpy inputs go
through the JAX package and its PyTorch port."""

import numpy as np
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
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


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
