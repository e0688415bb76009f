"""Batch normalization with torch BatchNorm2d semantics (NHWC).

The reference uses ``nn.BatchNorm2d`` inside every DoubleConv (reference:
mimo/models/mimo_components/components.py:24,27) with defaults eps=1e-5,
momentum=0.1, affine=True, track_running_stats=True.

Torch-parity details preserved here:
  * training mode normalizes with the *biased* batch variance but updates
    the running variance with the *unbiased* estimate;
  * running_mean/var update: r = (1-momentum)*r + momentum*batch_stat;
  * eval mode normalizes with running stats.

State is explicit: ``batch_norm`` returns the updated running stats, which
the caller threads through the train step (no module mutation).  Statistics
are computed in float32 even when activations are bfloat16.  Under ``jit``
with a batch-sharded mesh, the means below are global-batch means — XLA
inserts the cross-chip reductions, which reproduces the reference's
single-device global-batch statistics exactly.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def batch_norm_init(num_features: int, dtype=jnp.float32) -> Tuple[dict, dict]:
    """Returns (params, state): scale/bias and running mean/var (+num_batches)."""
    params = {
        "scale": jnp.ones((num_features,), dtype),
        "bias": jnp.zeros((num_features,), dtype),
    }
    state = {
        "mean": jnp.zeros((num_features,), jnp.float32),
        "var": jnp.ones((num_features,), jnp.float32),
    }
    return params, state


def batch_norm(
    x: jax.Array,
    params: dict,
    state: dict,
    *,
    train: bool,
    momentum: float = 0.1,
    eps: float = 1e-5,
    fold_conv_bias: jax.Array | None = None,
) -> Tuple[jax.Array, dict]:
    """Normalize over (N, H, W) per channel.  Returns (y, new_state).

    ``fold_conv_bias``: when the producing conv skipped its bias add
    (train mode only — the bias cancels out of ``x - mean`` analytically),
    pass the bias here so the *running* mean still tracks the biased conv
    output the eval path will see.  Saves a full elementwise memory pass
    per conv.
    """
    reduce_axes = tuple(range(x.ndim - 1))

    if train:
        # two-pass variance: the one-pass E[x^2] - E[x]^2 cancels
        # catastrophically in f32 for channels whose mean dwarfs their
        # spread, which visibly skews train-mode gradients
        # (tests/test_xla_model.py)
        xf = x.astype(jnp.float32)
        mean = jnp.mean(xf, axis=reduce_axes)
        var = jnp.mean(jnp.square(xf - mean), axis=reduce_axes)
        n = 1
        for a in reduce_axes:
            n *= x.shape[a]
        unbiased = var * (n / max(n - 1, 1))
        stat_mean = mean if fold_conv_bias is None else (
            mean + fold_conv_bias.astype(jnp.float32)
        )
        new_state = {
            "mean": (1 - momentum) * state["mean"] + momentum * stat_mean,
            "var": (1 - momentum) * state["var"] + momentum * unbiased,
        }
        # per-channel affine computed in f32, applied in the activation
        # dtype (same recipe as the eval branch below): avoids
        # materializing an f32 copy of x just to subtract the mean
        inv = jax.lax.rsqrt(var + eps) * params["scale"].astype(jnp.float32)
        shift = params["bias"].astype(jnp.float32) - mean * inv
        y = x * inv.astype(x.dtype) + shift.astype(x.dtype)
        return y, new_state

    # eval: the affine is a per-channel constant — compute it in f32 once,
    # apply in the activation dtype so XLA fuses it into the producing
    # conv's epilogue instead of round-tripping an f32 copy of x
    mean, var = state["mean"], state["var"]
    inv = jax.lax.rsqrt(var + eps) * params["scale"].astype(jnp.float32)
    shift = params["bias"].astype(jnp.float32) - mean * inv
    y = x * inv.astype(x.dtype) + shift.astype(x.dtype)
    return y, state
