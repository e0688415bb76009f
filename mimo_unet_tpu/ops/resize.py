"""Bilinear x2 upsampling with align_corners=True, and pad-to-match.

The reference ``Up`` block (reference: mimo/models/mimo_components/
components.py:78,106-119) upsamples with
``nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True)`` then
zero-pads to match the skip tensor and concatenates.

``jax.image.resize`` uses half-pixel centers, which differs from
align_corners by up to several 1e-2 — far beyond the 1e-3 parity budget —
so the align-corners gather/lerp is rolled by hand here.  Sampling grid:
``src = dst * (in - 1) / (out - 1)`` per spatial axis.  Because out = 2*in,
the index/weight tables are static arrays baked into the jitted program.
The model path contracts them as dense interpolation matrices
(``_upsample_hw_matmul``); the take/lerp form
(``_resize_axis_align_corners``) is the plain reference it is tested
against.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def _align_corners_tables(in_size: int, out_size: int):
    """Static (lo_idx, hi_idx, frac) tables for 1D align-corners resize."""
    if in_size == 1:
        lo = np.zeros(out_size, dtype=np.int32)
        return lo, lo, np.zeros(out_size, dtype=np.float32)
    src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    lo = np.floor(src).astype(np.int32)
    lo = np.clip(lo, 0, in_size - 2)
    frac = (src - lo).astype(np.float32)
    return lo, lo + 1, frac


def _resize_axis_align_corners(x: jax.Array, axis: int, out_size: int) -> jax.Array:
    in_size = x.shape[axis]
    if out_size == in_size:
        return x
    lo, hi, frac = _align_corners_tables(in_size, out_size)
    x_lo = jnp.take(x, jnp.asarray(lo), axis=axis)
    x_hi = jnp.take(x, jnp.asarray(hi), axis=axis)
    shape = [1] * x.ndim
    shape[axis] = out_size
    w = jnp.asarray(frac).astype(x.dtype).reshape(shape)
    return x_lo * (1 - w) + x_hi * w


def _interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense [out, in] align-corners interpolation matrix (<=2 nonzeros/row)."""
    lo, hi, frac = _align_corners_tables(in_size, out_size)
    mat = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(mat, (rows, lo), 1.0 - frac)
    np.add.at(mat, (rows, hi), frac)
    return mat


def _reflect_extend(mat: np.ndarray) -> np.ndarray:
    """Extend an interpolation matrix with reflect-pad rows: the padded
    output's row -1 equals output row 1 and row H equals row H-2, so the
    pad is two extra (copied) matrix rows — the pad becomes free."""
    return np.concatenate([mat[1:2], mat, mat[-2:-1]], axis=0)


def _upsample_hw_matmul(
    x: jax.Array, out_h: int, out_w: int, pad_output: bool = False
) -> jax.Array:
    """Bilinear align-corners resize as two dense matmuls.

    Contracts against the (banded, <=2 nonzeros per row) interpolation
    matrices instead of gathering: the form chosen on the machine this was
    first tuned on, where gathers ran as scalar dynamic-slices.  Whether
    it or a slice+lerp wins on the GPU is still to be measured (ROADMAP
    Queue 1, bilinear upsample).

    ``pad_output=True`` additionally emits the result reflect-padded by 1
    on H and W (two extra rows per interpolation matrix) — the consumer's
    reflect-pad conv then skips its pad entirely (see ops/conv.py
    ``prepadded``).

    Exact in f32 (HIGHEST matmul precision; extra terms multiply by 0.0);
    in bf16 the weights quantize like every other bf16 matmul operand.
    """
    h, w = x.shape[-3], x.shape[-2]
    mh = _interp_matrix(h, out_h)
    mw = _interp_matrix(w, out_w)
    if pad_output:
        mh, mw = _reflect_extend(mh), _reflect_extend(mw)
    wh = jnp.asarray(mh).astype(x.dtype)
    ww = jnp.asarray(mw).astype(x.dtype)
    precision = (
        jax.lax.Precision.HIGHEST if x.dtype == jnp.float32 else None
    )
    y = mat_einsum("oh,...hwc->...owc", "oh,...owc->...hwc", wh, x,
                   precision)
    return mat_einsum("pw,...owc->...opc", "pw,...opc->...owc", ww, y,
                      precision)


def mat_einsum(pattern_f, pattern_b, mat, x, precision=None):
    """einsum against a constant matrix with a layout-preserving VJP.

    XLA's autodiff of ``einsum(pattern_f, mat, x)`` can lower the cotangent
    contraction with relayout transposes.  The transpose of a linear map
    is the same einsum against the same matrix with the contracted index
    swapped — ``pattern_b`` states it in the operand's own layout, so the
    backward lowers exactly like the forward.
    ``mat`` is treated as a constant (interpolation tables): no cotangent.
    """
    @jax.custom_vjp
    def f(m, v):
        return jnp.einsum(pattern_f, m, v, precision=precision)

    def fwd(m, v):
        return f(m, v), m

    def bwd(m, g):
        # the matrix is threaded as a residual (NOT a closure: a captured
        # tracer leaks when the VJP is transposed inside shard_map)
        return (jnp.zeros_like(m),
                jnp.einsum(pattern_b, m, g, precision=precision))

    f.defvjp(fwd, bwd)
    return f(mat, x)


def upsample_bilinear_align_corners(
    x: jax.Array, out_h: int, out_w: int, *, pad_output: bool = False
) -> jax.Array:
    """NHWC bilinear resize with align_corners=True (torch semantics)."""
    return _upsample_hw_matmul(x, out_h, out_w, pad_output=pad_output)


def upsample_bilinear_x2_align_corners(
    x: jax.Array, *, pad_output: bool = False
) -> jax.Array:
    """NHWC x2 bilinear upsample, align_corners=True."""
    h, w = x.shape[-3], x.shape[-2]
    return upsample_bilinear_align_corners(
        x, 2 * h, 2 * w, pad_output=pad_output
    )


def pad_to_match(x: jax.Array, target_h: int, target_w: int) -> jax.Array:
    """Zero-pad NHWC spatial dims to (target_h, target_w), torch F.pad split.

    Mirrors components.py:112-115: pad = [dX//2, dX-dX//2, dY//2, dY-dY//2].
    Sizes are static under jit, so this folds away when no padding is needed
    (the common even-sized case).
    """
    dy = target_h - x.shape[-3]
    dx = target_w - x.shape[-2]
    if dy == 0 and dx == 0:
        return x
    pad = [(0, 0)] * (x.ndim - 3) + [
        (dy // 2, dy - dy // 2),
        (dx // 2, dx - dx // 2),
        (0, 0),
    ]
    return jnp.pad(x, pad)
