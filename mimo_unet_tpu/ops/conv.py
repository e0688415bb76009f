"""2D convolutions in NHWC layout.

The reference U-Net blocks (reference: mimo/models/mimo_components/
components.py:23-28) use 3x3 convs with reflect padding and 1x1 output
convs; the non-bilinear ``Up`` variant uses a 2x2 stride-2 transposed conv
(components.py:96-99).  Here they are expressed as
``lax.conv_general_dilated`` over NHWC/HWIO (cuDNN's preferred layouts).

Weights are stored HWIO: ``[kh, kw, in_channels // groups, out_channels]``.
Initialization matches ``torch.nn.Conv2d.reset_parameters`` (kaiming-uniform
with a=sqrt(5), i.e. U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for both weight and
bias) so parameter statistics are comparable with the reference.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

# NHWC activations, HWIO weights, NHWC outputs.
_DIMENSION_NUMBERS = ("NHWC", "HWIO", "NHWC")


@functools.lru_cache(maxsize=None)
def _reflect_pad_matrix(w: int) -> np.ndarray:
    """[W+2, W] 0/1 selection matrix implementing reflect pad of 1."""
    m = np.zeros((w + 2, w), np.float32)
    m[0, 1] = 1.0
    m[np.arange(1, w + 1), np.arange(w)] = 1.0
    m[w + 1, w - 2] = 1.0
    return m


def reflect_pad1(x: jax.Array) -> jax.Array:
    """Reflect-pad H and W by 1 (NHWC, any leading dims).

    H is padded with a major-dim concat and, for narrow channel counts
    (< 128), W by contracting a [W+2, W] 0/1 selection matrix instead of
    ``jnp.pad(mode="reflect")``; wide channels and W < 2 use plain
    ``jnp.pad``.  The matmul form answered a relayout cost of the machine
    this was first tuned on; which form wins on the GPU is still to be
    measured (ROADMAP Queue 1, reflect padding).

    Exact: each output element is 1.0 * x (HIGHEST precision for f32).
    """
    x = jnp.concatenate([x[..., 1:2, :, :], x, x[..., -2:-1, :, :]], axis=-3)
    c, w = x.shape[-1], x.shape[-2]
    if c >= 128 or w < 2:
        pad = [(0, 0)] * (x.ndim - 2) + [(1, 1), (0, 0)]
        return jnp.pad(x, pad, mode="reflect")
    from mimo_unet_tpu.ops.resize import mat_einsum

    mat = jnp.asarray(_reflect_pad_matrix(w)).astype(x.dtype)
    precision = lax.Precision.HIGHEST if x.dtype == jnp.float32 else None
    return mat_einsum("pw,...hwc->...hpc", "pw,...hpc->...hwc", mat, x,
                      precision)


def _conv3x3_reflect_fused(x: jax.Array, w: jax.Array, groups: int) -> jax.Array:
    """3x3 conv with 1px reflect padding, without materializing the pad.

    ``conv(reflect_pad1(x)) == conv_zero_same(x) + border corrections``:
    the zero-padded SAME conv covers every in-bounds tap; the taps that
    fell outside (valued at their reflect rows/cols: -1 -> 1, H -> H-2)
    are added back as eight tiny convs over 1-wide border slices, padded
    back to full size with zeros (XLA fuses the pads + adds into one
    epilogue pass).  Saves the two full memory passes reflect_pad1 spends
    materializing the padded tensor.

    Exact in f32 up to addition-order rounding; in bf16 the border pixels
    see one extra rounding (corrections are added post-conv).
    """
    conv = functools.partial(
        lax.conv_general_dilated,
        window_strides=(1, 1),
        dimension_numbers=_DIMENSION_NUMBERS,
        feature_group_count=groups,
    )
    y = conv(x, w, padding=[(1, 1), (1, 1)])
    # rows out of bounds, cols in bounds (zero pad drops the corner taps)
    r_top = conv(x[:, 1:2], w[0:1], padding=[(0, 0), (1, 1)])
    r_bot = conv(x[:, -2:-1], w[2:3], padding=[(0, 0), (1, 1)])
    # cols out of bounds, rows in bounds
    r_lef = conv(x[:, :, 1:2], w[:, 0:1], padding=[(1, 1), (0, 0)])
    r_rig = conv(x[:, :, -2:-1], w[:, 2:3], padding=[(1, 1), (0, 0)])
    # both out of bounds: the four corner taps
    c_tl = conv(x[:, 1:2, 1:2], w[0:1, 0:1], padding=[(0, 0), (0, 0)])
    c_tr = conv(x[:, 1:2, -2:-1], w[0:1, 2:3], padding=[(0, 0), (0, 0)])
    c_bl = conv(x[:, -2:-1, 1:2], w[2:3, 0:1], padding=[(0, 0), (0, 0)])
    c_br = conv(x[:, -2:-1, -2:-1], w[2:3, 2:3], padding=[(0, 0), (0, 0)])
    h, wd = y.shape[-3], y.shape[-2]

    def at(t, i, j):
        return jnp.pad(t, [(0, 0), (i, h - i - t.shape[-3]),
                           (j, wd - j - t.shape[-2]), (0, 0)])

    return (y + at(r_top, 0, 0) + at(r_bot, h - 1, 0)
            + at(r_lef, 0, 0) + at(r_rig, 0, wd - 1)
            + at(c_tl, 0, 0) + at(c_tr, 0, wd - 1)
            + at(c_bl, h - 1, 0) + at(c_br, h - 1, wd - 1))


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def _conv3x3_reflect_customgrad(x, w, groups):
    """_conv3x3_reflect_fused with the CLASSIC backward.

    Differentiating the fused forward makes XLA backward through the
    eight border-correction convs (scatter chains).  The gradient of
    conv(reflect_pad(x), w) doesn't care how the forward was computed, so
    the backward here is written out as the classic ops: dx = full
    correlation with the flipped/swapped kernel + reflect folds (W fold
    as the pad-matrix transpose contraction, H fold as two row adds);
    dw = the batch-contracting conv (XLA's standard weight-gradient
    formulation).  groups == 1 only (callers fall back otherwise).
    """
    return _conv3x3_reflect_fused(x, w, groups)


def _c3rc_fwd(x, w, groups):
    return _conv3x3_reflect_fused(x, w, groups), (x, w)


def _c3rc_bwd(groups, res, g):
    assert groups == 1
    x, w = res
    n, h, wd, _ = x.shape

    # ---- dx: full correlation, then fold the pad transpose back --------
    w_t = jnp.flip(w, (0, 1)).transpose(0, 1, 3, 2)  # [3, 3, CO, CI]
    dxp = lax.conv_general_dilated(
        g, w_t, (1, 1), [(2, 2), (2, 2)],
        dimension_numbers=_DIMENSION_NUMBERS)  # [N, H+2, W+2, CI]
    # W fold: transpose of the reflect-pad selection matrix
    mat = jnp.asarray(_reflect_pad_matrix(wd)).astype(dxp.dtype)
    precision = (lax.Precision.HIGHEST if dxp.dtype == jnp.float32
                 else None)
    dxw = jnp.einsum("pw,nhpc->nhwc", mat, dxp, precision=precision)
    # H fold: interior rows + reflect rows 1 / H-2
    dx = dxw[:, 1:-1]
    dx = dx.at[:, 1].add(dxw[:, 0])
    dx = dx.at[:, h - 2].add(dxw[:, -1])

    # ---- dw: batch-contracting conv over the re-padded input -----------
    xp = reflect_pad1(x)
    dw = lax.conv_general_dilated(
        xp, g, (1, 1), "VALID",
        dimension_numbers=("CHWN", "IHWO", "NHWC"))  # [CI, 3, 3, CO]
    return dx.astype(x.dtype), dw.transpose(1, 2, 0, 3).astype(w.dtype)


_conv3x3_reflect_customgrad.defvjp(_c3rc_fwd, _c3rc_bwd)


def conv2d_init(
    key: jax.Array,
    in_channels: int,
    out_channels: int,
    kernel_size: int,
    groups: int = 1,
    dtype=jnp.float32,
) -> dict:
    """Initialize conv weights: U(-b, b) with b = 1/sqrt(fan_in), torch style."""
    if in_channels % groups or out_channels % groups:
        raise ValueError("in/out channels must be divisible by groups")
    k_w, k_b = jax.random.split(key)
    fan_in = (in_channels // groups) * kernel_size * kernel_size
    bound = 1.0 / math.sqrt(fan_in)
    w = jax.random.uniform(
        k_w,
        (kernel_size, kernel_size, in_channels // groups, out_channels),
        dtype,
        -bound,
        bound,
    )
    b = jax.random.uniform(k_b, (out_channels,), dtype, -bound, bound)
    return {"w": w, "b": b}


def conv2d(
    x: jax.Array,
    params: dict,
    *,
    stride: int = 1,
    padding: str | int = 0,
    groups: int = 1,
    compute_dtype: Optional[jnp.dtype] = None,
    prepadded: bool = False,
    skip_bias: bool = False,
    fused_reflect: bool = False,
) -> jax.Array:
    """NHWC conv. ``padding``: int (zero pad), "SAME", "VALID" or "REFLECT".

    ``skip_bias=True`` omits the bias add (a separate memory pass): used when
    a train-mode BatchNorm follows, which cancels the bias analytically —
    the caller folds it into the BN running mean instead
    (ops/norm.py::batch_norm fold_conv_bias).

    "REFLECT" applies torch's ``padding_mode="reflect"`` with pad = (k-1)//2
    (the DoubleConv 3x3 configuration) before a VALID conv; pass
    ``prepadded=True`` when the caller already emitted a padded input
    (e.g. the pad-emitting bilinear upsample) to skip the pad entirely.

    ``compute_dtype`` casts inputs and weights (e.g. to bfloat16) and the
    output *stays* in that dtype — the mixed-precision recipe: bf16
    activations end-to-end (the conv accumulates in f32), f32 master
    weights, f32 upcast only at normalization/loss boundaries.
    (``preferred_element_type`` upcasting is avoided: jax 0.9's conv
    transpose rule mismatches dtypes when differentiating through it.)
    """
    w, b = params["w"], params["b"]
    kh, kw = w.shape[0], w.shape[1]

    if compute_dtype is not None:
        x = x.astype(compute_dtype)
        w = w.astype(compute_dtype)
    elif x.dtype != w.dtype:
        w = w.astype(x.dtype)

    if padding == "REFLECT":
        if not prepadded:
            ph, pw = (kh - 1) // 2, (kw - 1) // 2
            # ``fused_reflect`` opts into the pad-free formulation.  Under
            # autodiff it pairs with the classic backward via
            # _conv3x3_reflect_customgrad rather than letting XLA
            # differentiate the correction convs; groups > 1 falls
            # through to the pad path.
            if (fused_reflect
                    and (ph, pw) == (1, 1) and stride == 1 and x.ndim == 4
                    and x.shape[-3] >= 2 and x.shape[-2] >= 2):
                if groups == 1:
                    y = _conv3x3_reflect_customgrad(x, w, groups)
                else:
                    y = _conv3x3_reflect_fused(x, w, groups)
                if skip_bias:
                    return y
                return y + b.astype(y.dtype)
            if (ph, pw) == (1, 1):
                x = reflect_pad1(x)
            else:
                x = jnp.pad(
                    x, ((0, 0), (ph, ph), (pw, pw), (0, 0)), mode="reflect"
                )
        pad_cfg = "VALID"
    elif isinstance(padding, int):
        pad_cfg = [(padding, padding), (padding, padding)]
    else:
        pad_cfg = padding

    y = lax.conv_general_dilated(
        x,
        w,
        window_strides=(stride, stride),
        padding=pad_cfg,
        dimension_numbers=_DIMENSION_NUMBERS,
        feature_group_count=groups,
    )
    if skip_bias:
        return y
    return y + b.astype(y.dtype)


def conv_transpose2d_init(
    key: jax.Array,
    in_channels: int,
    out_channels: int,
    kernel_size: int,
    groups: int = 1,
    dtype=jnp.float32,
) -> dict:
    """torch ConvTranspose2d init: fan_in = (out_channels // groups) * k * k.

    (torch computes fan_in from weight shape [in, out//groups, k, k] whose
    dim-1 * receptive field is out//groups * k * k.)
    """
    k_w, k_b = jax.random.split(key)
    fan_in = (out_channels // groups) * kernel_size * kernel_size
    bound = 1.0 / math.sqrt(fan_in)
    # Stored HWIO for the equivalent forward conv on the dilated input:
    # [kh, kw, in_channels // groups, out_channels].
    w = jax.random.uniform(
        k_w,
        (kernel_size, kernel_size, in_channels // groups, out_channels),
        dtype,
        -bound,
        bound,
    )
    b = jax.random.uniform(k_b, (out_channels,), dtype, -bound, bound)
    return {"w": w, "b": b}


def conv_transpose2d(
    x: jax.Array,
    params: dict,
    *,
    stride: int = 2,
    groups: int = 1,
    compute_dtype: Optional[jnp.dtype] = None,
) -> jax.Array:
    """Transposed conv (kernel 2, stride 2 in the reference ``Up`` variant).

    Implemented as input-dilated convolution with a spatially-flipped kernel,
    which is exactly torch's ConvTranspose2d forward.
    """
    w, b = params["w"], params["b"]
    kh, kw = w.shape[0], w.shape[1]
    if compute_dtype is not None:
        x = x.astype(compute_dtype)
        w = w.astype(compute_dtype)
    elif x.dtype != w.dtype:
        w = w.astype(x.dtype)
    y = lax.conv_general_dilated(
        x,
        jnp.flip(w, axis=(0, 1)),
        window_strides=(1, 1),
        padding=[(kh - 1, kh - 1), (kw - 1, kw - 1)],
        lhs_dilation=(stride, stride),
        dimension_numbers=_DIMENSION_NUMBERS,
        feature_group_count=groups,
    )
    return y + b.astype(y.dtype)
