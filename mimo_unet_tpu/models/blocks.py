"""U-Net building blocks as pure init/apply pairs (NHWC).

Functional rebuild of the reference blocks (reference: mimo/models/
mimo_components/components.py):
  * DoubleConv (:8-33):  (3x3 reflect conv -> BN -> ReLU) x2 -> Dropout2d
  * Down       (:36-57): MaxPool2d(2) [optionally with indices] -> DoubleConv
  * Up         (:60-120): bilinear x2 (align_corners) | MaxUnpool2d |
                ConvTranspose2d, then pad-to-match -> concat skip -> DoubleConv
  * OutConv    (:123-129): 1x1 conv

Every block is two pure functions: ``*_init(key, ...) -> (params, state)``
and ``*_apply(params, state, x, ...) -> (y, new_state)``.  ``state`` holds
batch-norm running statistics.  Blocks carry no Python objects, so the whole
model nests into one pytree and vmaps over a stacked subnetwork axis.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from mimo_unet_tpu.ops import (
    batch_norm,
    batch_norm_init,
    conv2d,
    conv2d_init,
    conv_transpose2d,
    conv_transpose2d_init,
    dropout,
    dropout2d,
    max_pool_2x2,
    max_pool_2x2_with_indices,
    max_unpool_2x2,
    pad_to_match,
    upsample_bilinear_x2_align_corners,
)

# ---------------------------------------------------------------------------
# DoubleConv


def double_conv_init(
    key: jax.Array,
    in_channels: int,
    out_channels: int,
    mid_channels: Optional[int] = None,
    groups: int = 1,
) -> Tuple[dict, dict]:
    mid = mid_channels or out_channels
    k1, k2 = jax.random.split(key)
    c1 = conv2d_init(k1, in_channels, mid, 3, groups=groups)
    bn1_p, bn1_s = batch_norm_init(mid)
    c2 = conv2d_init(k2, mid, out_channels, 3, groups=groups)
    bn2_p, bn2_s = batch_norm_init(out_channels)
    params = {"conv1": c1, "bn1": bn1_p, "conv2": c2, "bn2": bn2_p}
    state = {"bn1": bn1_s, "bn2": bn2_s}
    return params, state


def double_conv_apply(
    params: dict,
    state: dict,
    x: jax.Array,
    *,
    train: bool,
    dropout_rate: float = 0.0,
    dropout_key: Optional[jax.Array] = None,
    mc_dropout: bool = False,
    groups: int = 1,
    compute_dtype=None,
    input_prepadded: bool = False,
    pair: Optional[Tuple[jax.Array, jax.Array]] = None,
) -> Tuple[jax.Array, dict]:
    """``input_prepadded``: x already carries the 1px reflect halo for the
    first conv (emitted for free by the pad-emitting upsample).

    ``pair=(xa, xb)``: the first conv consumes the channel concat of two
    prepadded tensors WITHOUT materializing it — ``conv1(cat([xa, xb])) ==
    conv1_a(xa) + conv1_b(xb)`` with the weights split on input channels.
    Skipping the concat removes a full memory round-trip of the widest
    activation in every Up block.  Requires groups == 1; ``x`` is
    ignored."""
    # train-mode BN cancels the conv bias analytically: skip the bias-add
    # memory pass and fold the bias into the BN running mean instead
    # (ops/norm.py::batch_norm fold_conv_bias)
    fold = train
    b1_fold = params["conv1"]["b"] if fold else None
    # pad-free reflect formulation; under train its custom VJP supplies
    # the classic backward (ops/conv.py::_conv3x3_reflect_customgrad)
    freflect = not train
    if pair is not None:
        assert groups == 1, "pair input requires ungrouped conv1"
        xa, xb = pair
        ca = xa.shape[-1]
        w1, b1 = params["conv1"]["w"], params["conv1"]["b"]
        y = conv2d(xa, {"w": w1[:, :, :ca], "b": b1}, padding="REFLECT",
                   compute_dtype=compute_dtype, prepadded=True,
                   skip_bias=fold)
        y = y + conv2d(
            xb, {"w": w1[:, :, ca:], "b": jnp.zeros_like(b1)},
            padding="REFLECT", compute_dtype=compute_dtype, prepadded=True,
            skip_bias=True)
    else:
        y = conv2d(x, params["conv1"], padding="REFLECT", groups=groups,
                   compute_dtype=compute_dtype, prepadded=input_prepadded,
                   skip_bias=fold, fused_reflect=freflect)
    y, bn1_s = batch_norm(y, params["bn1"], state["bn1"], train=train,
                          fold_conv_bias=b1_fold)
    y = jnp.maximum(y, 0)
    y = conv2d(y, params["conv2"], padding="REFLECT", groups=groups,
               compute_dtype=compute_dtype, skip_bias=fold,
               fused_reflect=freflect)
    y, bn2_s = batch_norm(y, params["bn2"], state["bn2"], train=train,
                          fold_conv_bias=params["conv2"]["b"] if fold else None)
    y = jnp.maximum(y, 0)
    y = dropout2d(y, dropout_rate, dropout_key,
                  deterministic=not (train or mc_dropout))
    return y, {"bn1": bn1_s, "bn2": bn2_s}


# ---------------------------------------------------------------------------
# Down


def down_init(key, in_channels, out_channels) -> Tuple[dict, dict]:
    return double_conv_init(key, in_channels, out_channels)


def down_apply(
    params: dict,
    state: dict,
    x: jax.Array,
    *,
    train: bool,
    use_pooling_indices: bool = False,
    dropout_rate: float = 0.0,
    dropout_key: Optional[jax.Array] = None,
    mc_dropout: bool = False,
    compute_dtype=None,
    pre_pooled: bool = False,
):
    """Returns ((y, indices_or_None), new_state).

    ``pre_pooled``: ``x`` is already the pooled tensor (the caller pooled
    it via ``max_pool_2x2_skip`` to fuse a skip consumer's cotangent into
    the pool backward — see core_apply)."""
    if pre_pooled:
        assert not use_pooling_indices
        y, indices = x, None
    elif use_pooling_indices:
        y, indices = max_pool_2x2_with_indices(x)
    else:
        y, indices = max_pool_2x2(x), None
    y, new_state = double_conv_apply(
        params, state, y, train=train, dropout_rate=dropout_rate,
        dropout_key=dropout_key, mc_dropout=mc_dropout,
        compute_dtype=compute_dtype,
    )
    return (y, indices), new_state


# ---------------------------------------------------------------------------
# Up

UP_BILINEAR = "bilinear"
UP_UNPOOL = "unpool"
UP_TRANSPOSE = "transpose"


def up_mode(bilinear: bool, use_pooling_indices: bool) -> str:
    assert int(bilinear) + int(use_pooling_indices) <= 1, (
        "Do not specify use_pooling_indices and bilinear together!"
    )
    if bilinear:
        return UP_BILINEAR
    if use_pooling_indices:
        return UP_UNPOOL
    return UP_TRANSPOSE


def up_init(
    key: jax.Array,
    in_channels: int,
    out_channels: int,
    mode: str,
    groups: int = 1,
    x1_channels: Optional[int] = None,
) -> Tuple[dict, dict]:
    """``in_channels`` is the post-concat channel count (skip + upsampled).

    ``x1_channels`` (transpose mode only) is the channel count of the
    tensor the ConvTranspose2d actually receives, when it differs from
    ``in_channels``.  The classic U-Net core has x1 == in (skip is half),
    which is what the reference hardcodes (components.py:97-99); the
    MIMO decoder's up4 does not (core output 2FS/f vs skip F), which is
    exactly where the reference's own channel math breaks — passing the
    true ``x1_channels`` is the corrected wiring (docs/MIGRATION.md)."""
    if mode in (UP_BILINEAR, UP_UNPOOL):
        params, state = double_conv_init(
            key, in_channels, out_channels, mid_channels=in_channels // 2,
            groups=groups,
        )
        return {"conv": params}, {"conv": state}
    k_up, k_conv = jax.random.split(key)
    x1c = in_channels if x1_channels is None else x1_channels
    up = conv_transpose2d_init(k_up, x1c, x1c // 2, 2, groups=groups)
    params, state = double_conv_init(k_conv, in_channels, out_channels, groups=groups)
    return {"up": up, "conv": params}, {"conv": state}


def up_apply(
    params: dict,
    state: dict,
    x1: jax.Array,
    x2: jax.Array,
    pooling_indices: Optional[jax.Array],
    *,
    mode: str,
    train: bool,
    dropout_rate: float = 0.0,
    dropout_key: Optional[jax.Array] = None,
    mc_dropout: bool = False,
    groups: int = 1,
    compute_dtype=None,
    split_skip_conv: bool = False,
) -> Tuple[jax.Array, dict]:
    """Upsample ``x1``, pad to ``x2``'s spatial size, concat [x2, x1], conv.

    Fast path (bilinear, even sizes): the upsample matmul emits its output
    already reflect-padded, the skip is padded once with the cheap
    selection-matrix pad, and the first conv of the DoubleConv skips its
    pad entirely.
    """
    if (
        mode == UP_BILINEAR
        and 2 * x1.shape[-3] == x2.shape[-3]
        and 2 * x1.shape[-2] == x2.shape[-2]
        and groups == 1
    ):
        from mimo_unet_tpu.ops.conv import reflect_pad1

        x1 = upsample_bilinear_x2_align_corners(x1, pad_output=True)
        # (the skip stays pre-padded: feeding it unpadded through the
        # fused reflect conv breaks the split-add fusion)
        x2 = reflect_pad1(x2)
        if split_skip_conv:
            # split-conv fast path: conv1 consumes the (prepadded) skip
            # and upsampled tensors directly — the [x2, x1] concat
            # (reference components.py:119) folds into the weight split
            # and never materializes.  Used by the shared core; it is
            # opt-in because the vmapped per-subnetwork decoders lowered
            # the split badly on the machine this was first tuned on (to
            # be priced on the GPU, ROADMAP Queue 3 item 2).
            y, conv_state = double_conv_apply(
                params["conv"], state["conv"], x1, train=train,
                dropout_rate=dropout_rate, dropout_key=dropout_key,
                mc_dropout=mc_dropout, compute_dtype=compute_dtype,
                pair=(x2, x1),
            )
            return y, {"conv": conv_state}
        x = jnp.concatenate([x2, x1], axis=-1)
        y, conv_state = double_conv_apply(
            params["conv"], state["conv"], x, train=train,
            dropout_rate=dropout_rate, dropout_key=dropout_key,
            mc_dropout=mc_dropout, compute_dtype=compute_dtype,
            input_prepadded=True,
        )
        return y, {"conv": conv_state}

    if mode == UP_BILINEAR:
        x1 = upsample_bilinear_x2_align_corners(x1)
    elif mode == UP_UNPOOL:
        h, w = x1.shape[-3] * 2, x1.shape[-2] * 2
        x1 = max_unpool_2x2(x1, pooling_indices, h, w)
    else:
        x1 = conv_transpose2d(x1, params["up"], stride=2, groups=groups,
                              compute_dtype=compute_dtype)
    x1 = pad_to_match(x1, x2.shape[-3], x2.shape[-2])

    x = jnp.concatenate([x2, x1], axis=-1)
    y, conv_state = double_conv_apply(
        params["conv"], state["conv"], x, train=train,
        dropout_rate=dropout_rate, dropout_key=dropout_key,
        mc_dropout=mc_dropout, groups=groups, compute_dtype=compute_dtype,
    )
    return y, {"conv": conv_state}


# ---------------------------------------------------------------------------
# OutConv


def out_conv_init(key, in_channels, out_channels, groups: int = 1) -> dict:
    return conv2d_init(key, in_channels, out_channels, 1, groups=groups)


def out_conv_apply(params, x, *, groups: int = 1, compute_dtype=None):
    return conv2d(x, params, padding=0, groups=groups, compute_dtype=compute_dtype)
