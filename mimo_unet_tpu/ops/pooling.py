"""2x2 max pooling and index-based unpooling (NHWC).

Covers the reference ``Down`` block (reference: mimo/models/mimo_components/
components.py:36-57: MaxPool2d(2), optionally return_indices) and the
``MaxUnpool2d`` path of ``Up`` (components.py:92,107).

Instead of torch's flat scatter indices, pooling-with-indices here keeps a
*local* 2x2 argmax code (0..3) per output pixel; unpooling turns the code
into a one-hot over the 2x2 window and multiplies — no gather/scatter at
all, just reshapes and a vectorized select, which XLA maps cleanly onto the
VPU.  Torch flat-index parity is provided for interop tests via
``local_to_torch_flat_indices``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


@jax.custom_vjp
def max_pool_2x2(x: jax.Array) -> jax.Array:
    """NHWC 2x2/stride-2 max pool. Odd trailing row/col is dropped (torch floor).

    Custom VJP: instead of the default ``reduce_window`` gradient
    (select-and-scatter), the backward routes the cotangent with one
    equality mask and a broadcast — one elementwise fusion.  Under exact ties
    inside a window the gradient goes to every tied element (torch picks
    one); ties are measure-zero for continuous activations.
    """
    return _max_pool_2x2_fwd_value(x)


def _max_pool_2x2_fwd_value(x: jax.Array) -> jax.Array:
    # reduce_window for the forward: a reshape-based max would split the
    # W dimension
    b, h, w, c = x.shape
    x = x[:, : h - h % 2, : w - w % 2, :]
    init = (
        -jnp.inf
        if jnp.issubdtype(x.dtype, jnp.floating)
        else jnp.iinfo(x.dtype).min
    )
    return lax.reduce_window(
        x, init, lax.max,
        window_dimensions=(1, 2, 2, 1),
        window_strides=(1, 2, 2, 1),
        padding="VALID",
    )


def _max_pool_2x2_fwd(x):
    y = _max_pool_2x2_fwd_value(x)
    return y, (x, y)


def _max_pool_2x2_bwd(res, g):
    x, y = res
    b, h, w, c = x.shape
    he, we = h - h % 2, w - w % 2
    xw = x[:, :he, :we, :].reshape(b, he // 2, 2, we // 2, 2, c)
    mask = (xw == y[:, :, None, :, None, :]).astype(g.dtype)
    gx = (mask * g[:, :, None, :, None, :]).reshape(b, he, we, c)
    if (he, we) != (h, w):
        gx = jnp.pad(gx, ((0, 0), (0, h - he), (0, w - we), (0, 0)))
    return (gx,)


max_pool_2x2.defvjp(_max_pool_2x2_fwd, _max_pool_2x2_bwd)


@jax.custom_vjp
def max_pool_2x2_skip(x: jax.Array):
    """(pooled, skip=x) for a tensor consumed by BOTH a 2x2 max pool and a
    skip connection (the U-Net Down inputs that the Up blocks also read,
    reference model.py:178-243).

    Forward is ``max_pool_2x2`` plus an identity.  The value is the
    backward: routing the skip consumer through the returned identity lets
    the skip cotangent fold into the pool's equality-mask fusion
    (``mask * g_up + g_skip`` in one XLA pass), so the full-resolution
    ``add_any`` merge of the two consumers' cotangents — three memory passes
    over the skip tensor — never materializes.  Gradients are exactly the
    unfused pair's (tests/test_ops.py)."""
    return _max_pool_2x2_fwd_value(x), x


def _max_pool_2x2_skip_fwd(x):
    y = _max_pool_2x2_fwd_value(x)
    return (y, x), (x, y)


def _max_pool_2x2_skip_bwd(res, gs):
    x, y = res
    g, g_skip = gs
    b, h, w, c = x.shape
    he, we = h - h % 2, w - w % 2
    xw = x[:, :he, :we, :].reshape(b, he // 2, 2, we // 2, 2, c)
    mask = (xw == y[:, :, None, :, None, :]).astype(g.dtype)
    gx = (mask * g[:, :, None, :, None, :]).reshape(b, he, we, c)
    if (he, we) != (h, w):
        gx = jnp.pad(gx, ((0, 0), (0, h - he), (0, w - we), (0, 0)))
    return (gx + g_skip.astype(gx.dtype),)


max_pool_2x2_skip.defvjp(_max_pool_2x2_skip_fwd, _max_pool_2x2_skip_bwd)


def _as_windows(x: jax.Array):
    """[B,H,W,C] -> [B,H/2,W/2,C,4] where the last axis enumerates the 2x2
    window in row-major order (matching torch's flat-index order)."""
    b, h, w, c = x.shape
    x = x[:, : h - h % 2, : w - w % 2, :]
    xw = x.reshape(b, h // 2, 2, w // 2, 2, c)
    xw = xw.transpose(0, 1, 3, 5, 2, 4)  # [B, H/2, W/2, C, 2, 2]
    return xw.reshape(b, h // 2, w // 2, c, 4)


def max_pool_2x2_with_indices(x: jax.Array):
    """Returns (pooled [B,H/2,W/2,C], local_idx int32 [B,H/2,W/2,C] in 0..3).

    ``local_idx`` is the row-major argmax within each 2x2 window; ties pick
    the first occurrence, matching torch's MaxPool2d(return_indices=True).
    """
    xw = _as_windows(x)
    idx = jnp.argmax(xw, axis=-1).astype(jnp.int32)
    pooled = jnp.max(xw, axis=-1)
    return pooled, idx


def max_unpool_2x2(x: jax.Array, local_idx: jax.Array, out_h: int, out_w: int) -> jax.Array:
    """Inverse of max_pool_2x2_with_indices: place each value at its argmax
    position within the 2x2 window, zeros elsewhere."""
    b, hp, wp, c = x.shape
    onehot = jax.nn.one_hot(local_idx, 4, dtype=x.dtype)  # [B,Hp,Wp,C,4]
    y = x[..., None] * onehot
    y = y.reshape(b, hp, wp, c, 2, 2).transpose(0, 1, 4, 2, 5, 3)
    y = y.reshape(b, hp * 2, wp * 2, c)
    if (out_h, out_w) != (hp * 2, wp * 2):
        pad = [(0, 0), (0, out_h - hp * 2), (0, out_w - wp * 2), (0, 0)]
        y = jnp.pad(y, pad)
    return y


def local_to_torch_flat_indices(local_idx: jax.Array, in_w: int) -> jax.Array:
    """Convert local 2x2 codes to torch MaxPool2d flat indices (h*W + w),
    for cross-framework tests."""
    b, hp, wp, c = local_idx.shape
    i = jnp.arange(hp, dtype=jnp.int32).reshape(1, hp, 1, 1)
    j = jnp.arange(wp, dtype=jnp.int32).reshape(1, 1, wp, 1)
    r, s = local_idx // 2, local_idx % 2
    return (2 * i + r) * in_w + (2 * j + s)
