"""The NHWC ops the model runs, each against a plain reference built from
``jnp.pad``/``lax`` primitives: reflect padding (selection-matrix and pad
branches), the pad-free reflect conv and its custom VJP, the matmul
upsample, the fused-skip max pool, the split skip conv and pad_to_match."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from mimo_unet_tpu.models.blocks import up_apply, up_init
from mimo_unet_tpu.ops.conv import conv2d, conv2d_init, reflect_pad1
from mimo_unet_tpu.ops.pooling import max_pool_2x2, max_pool_2x2_skip
from mimo_unet_tpu.ops.resize import (
    _resize_axis_align_corners,
    pad_to_match,
    upsample_bilinear_align_corners,
)

HI = lax.Precision.HIGHEST


def _x(shape, seed=0, dtype=np.float32):
    return jnp.asarray(
        np.random.default_rng(seed).standard_normal(shape).astype(dtype))


def _plain_reflect(x):
    pad = [(0, 0)] * (x.ndim - 3) + [(1, 1), (1, 1), (0, 0)]
    return jnp.pad(x, pad, mode="reflect")


def _plain_conv(x, w, b, groups=1):
    y = lax.conv_general_dilated(
        _plain_reflect(x), w, (1, 1), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups, precision=HI)
    return y + b


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-6)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


# ------------------------------------------------------------- reflect pad

@pytest.mark.parametrize("shape", [
    (2, 5, 8, 3),      # narrow channels: selection-matrix branch
    (1, 7, 17, 21),    # flagship width, odd W
    (2, 4, 6, 128),    # >= 128 channels: jnp.pad branch
    (2, 3, 2, 5),      # W == 2: smallest reflectable width
    (3, 2, 4, 6, 4),   # extra leading (subnetwork) dim
])
def test_reflect_pad1_matches_jnp_pad(shape):
    x = _x(shape)
    np.testing.assert_array_equal(np.asarray(reflect_pad1(x)),
                                  np.asarray(_plain_reflect(x)))


def test_reflect_pad1_bf16_exact():
    x = _x((2, 6, 9, 7)).astype(jnp.bfloat16)
    got = reflect_pad1(x)
    assert got.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got, np.float32),
                                  np.asarray(_plain_reflect(x), np.float32))


@pytest.mark.parametrize("shape", [(2, 5, 8, 3), (1, 4, 6, 128),
                                   (2, 3, 2, 5)])
def test_reflect_pad1_grad_matches_jnp_pad(shape):
    x = _x(shape)
    g = _x((shape[0], shape[1] + 2, shape[2] + 2, shape[3]), seed=1)
    got = jax.grad(lambda v: jnp.sum(reflect_pad1(v) * g))(x)
    want = jax.grad(lambda v: jnp.sum(_plain_reflect(v) * g))(x)
    _close(got, want, 1e-6)


# -------------------------------------------------- pad-free reflect conv

CONV_SHAPES = [(2, 8, 8, 3, 5), (1, 7, 9, 4, 4), (2, 2, 2, 3, 2),
               (1, 16, 5, 21, 21)]


@pytest.mark.parametrize("n,h,w,cin,cout", CONV_SHAPES)
def test_fused_reflect_conv_forward(n, h, w, cin, cout):
    x = _x((n, h, w, cin))
    p = conv2d_init(jax.random.key(0), cin, cout, 3)
    with jax.default_matmul_precision("highest"):
        got = conv2d(x, p, padding="REFLECT", fused_reflect=True)
    _close(got, _plain_conv(x, p["w"], p["b"]))


@pytest.mark.parametrize("n,h,w,cin,cout", CONV_SHAPES)
def test_fused_reflect_conv_grads(n, h, w, cin, cout):
    """The custom VJP (classic dx/dw) against autodiff of the plain
    conv over a reflect pad."""
    x = _x((n, h, w, cin))
    p = conv2d_init(jax.random.key(0), cin, cout, 3)
    g = _x((n, h, w, cout), seed=2)

    def loss(fn):
        return lambda v, w_: jnp.sum(fn(v, w_) * g)

    with jax.default_matmul_precision("highest"):
        dx, dw = jax.grad(loss(lambda v, w_: conv2d(
            v, {"w": w_, "b": p["b"]}, padding="REFLECT",
            fused_reflect=True)), argnums=(0, 1))(x, p["w"])
        rx, rw = jax.grad(loss(lambda v, w_: _plain_conv(v, w_, p["b"])),
                          argnums=(0, 1))(x, p["w"])
    _close(dx, rx)
    _close(dw, rw)


def test_fused_reflect_grouped_conv_forward():
    x = _x((2, 6, 7, 8))
    p = conv2d_init(jax.random.key(1), 8, 4, 3, groups=2)
    with jax.default_matmul_precision("highest"):
        got = conv2d(x, p, padding="REFLECT", groups=2, fused_reflect=True)
    _close(got, _plain_conv(x, p["w"], p["b"], groups=2))


def test_fused_reflect_conv_bf16_close_to_f32():
    x = _x((2, 8, 8, 21))
    p = conv2d_init(jax.random.key(0), 21, 21, 3)
    got = conv2d(x, p, padding="REFLECT", fused_reflect=True,
                 compute_dtype=jnp.bfloat16)
    assert got.dtype == jnp.bfloat16
    want = _plain_conv(x, p["w"], p["b"])
    rel = float(jnp.linalg.norm(got.astype(jnp.float32) - want)
                / jnp.linalg.norm(want))
    assert rel < 1e-2


# --------------------------------------------------------- matmul upsample

def _plain_upsample(x, oh, ow, pad_output):
    y = _resize_axis_align_corners(x, x.ndim - 3, oh)
    y = _resize_axis_align_corners(y, x.ndim - 2, ow)
    return _plain_reflect(y) if pad_output else y


UP_SIZES = [(1, 4), (3, 5), (8, 8), (5, 2)]


@pytest.mark.parametrize("pad_output", [False, True])
@pytest.mark.parametrize("h,w", UP_SIZES)
def test_matmul_upsample_matches_take_lerp(h, w, pad_output):
    x = _x((2, h, w, 3))
    got = upsample_bilinear_align_corners(x, 2 * h, 2 * w,
                                          pad_output=pad_output)
    _close(got, _plain_upsample(x, 2 * h, 2 * w, pad_output), 1e-6)


@pytest.mark.parametrize("pad_output", [False, True])
@pytest.mark.parametrize("h,w", [(3, 5), (4, 4)])
def test_matmul_upsample_grad_matches_take_lerp(h, w, pad_output):
    """The layout-preserving mat_einsum VJP against autodiff of the
    take/lerp form."""
    x = _x((2, h, w, 4))
    oh, ow = 2 * h + 2 * pad_output, 2 * w + 2 * pad_output
    g = _x((2, oh, ow, 4), seed=3)
    got = jax.grad(lambda v: jnp.sum(upsample_bilinear_align_corners(
        v, 2 * h, 2 * w, pad_output=pad_output) * g))(x)
    want = jax.grad(lambda v: jnp.sum(
        _plain_upsample(v, 2 * h, 2 * w, pad_output) * g))(x)
    _close(got, want, 1e-5)


# ----------------------------------------------------------------- pooling

def _plain_pool(x):
    return lax.reduce_window(x, -jnp.inf, lax.max, (1, 2, 2, 1),
                             (1, 2, 2, 1), "VALID")


POOL_SIZES = [(5, 7), (6, 6), (7, 3), (2, 5)]


@pytest.mark.parametrize("h,w", POOL_SIZES)
def test_max_pool_skip_forward(h, w):
    x = _x((2, h, w, 3))
    pooled, skip = max_pool_2x2_skip(x)
    np.testing.assert_array_equal(np.asarray(pooled),
                                  np.asarray(_plain_pool(x)))
    np.testing.assert_array_equal(np.asarray(skip), np.asarray(x))


@pytest.mark.parametrize("h,w", POOL_SIZES)
def test_max_pool_skip_both_cotangents(h, w):
    """Pool and skip cotangents fused in one backward == autodiff of the
    plain pool plus the identity, at odd sizes (floored rows get only the
    skip cotangent)."""
    x = _x((2, h, w, 3))
    gp = _x((2, h // 2, w // 2, 3), seed=4)
    gs = _x((2, h, w, 3), seed=5)

    def fused(v):
        p, s = max_pool_2x2_skip(v)
        return jnp.sum(p * gp) + jnp.sum(s * gs)

    def plain(v):
        return jnp.sum(_plain_pool(v) * gp) + jnp.sum(v * gs)

    _close(jax.grad(fused)(x), jax.grad(plain)(x), 1e-6)


@pytest.mark.parametrize("h,w", POOL_SIZES)
def test_max_pool_grad_matches_reduce_window(h, w):
    x = _x((2, h, w, 3))
    g = _x((2, h // 2, w // 2, 3), seed=6)
    got = jax.grad(lambda v: jnp.sum(max_pool_2x2(v) * g))(x)
    want = jax.grad(lambda v: jnp.sum(_plain_pool(v) * g))(x)
    _close(got, want, 1e-6)


# ------------------------------------------------------- split skip conv

@pytest.mark.parametrize("train", [False, True])
def test_split_skip_conv_matches_concat(train):
    """conv1 over the [skip, upsampled] concat == the weight-split sum the
    core's Up blocks use; forward, BN state and gradients."""
    params, state = up_init(jax.random.key(0), 16, 6, "bilinear")
    x1 = _x((2, 4, 4, 8), seed=7)
    x2 = _x((2, 8, 8, 8), seed=8)

    def run(split):
        def f(p):
            y, st = up_apply(p, state, x1, x2, None, mode="bilinear",
                             train=train, split_skip_conv=split)
            return jnp.sum(y * y), (y, st)
        with jax.default_matmul_precision("highest"):
            return jax.grad(f, has_aux=True)(params)

    g_split, (y_split, st_split) = run(True)
    g_cat, (y_cat, st_cat) = run(False)
    _close(y_split, y_cat)
    for a, b in zip(jax.tree.leaves((st_split, g_split)),
                    jax.tree.leaves((st_cat, g_cat))):
        _close(a, b, 1e-4)


# ------------------------------------------------------------ pad_to_match

@pytest.mark.parametrize("dy,dx", [(1, 0), (0, 3), (2, 1), (3, 3), (0, 0)])
def test_pad_to_match_torch_split(dy, dx):
    """torch F.pad split: [dX//2, dX - dX//2] zeros before/after."""
    x = _x((2, 3, 4, 2))
    got = np.asarray(pad_to_match(x, 3 + dy, 4 + dx))
    want = np.zeros((2, 3 + dy, 4 + dx, 2), np.float32)
    want[:, dy // 2:dy // 2 + 3, dx // 2:dx // 2 + 4] = np.asarray(x)
    np.testing.assert_array_equal(got, want)
