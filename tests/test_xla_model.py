"""The whole MIMO U-Net (``mimo_unet_apply``) against a plain composition
of the reference architecture written here from ``jnp.pad``, ``lax`` and
``jnp.take`` primitives: no selection-matrix pad, pad-free conv, matmul
upsample, split skip conv or custom pool VJP.  Forward, BatchNorm state
and gradients, over subnetwork counts, the three Up modes, remat rungs, a
640x480-proportioned frame (odd sizes, pad_to_match) and MC spatial
dropout masks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from mimo_unet_tpu.models import MimoUNetConfig, mimo_unet_apply, mimo_unet_init
from mimo_unet_tpu.ops.resize import _resize_axis_align_corners

HI = lax.Precision.HIGHEST
TOL_TRAIN = 5e-4


# ---------------------------------------------------- plain composition

def conv(x, p, reflect):
    if reflect:
        x = jnp.pad(x, [(0, 0), (1, 1), (1, 1), (0, 0)], mode="reflect")
    y = lax.conv_general_dilated(x, p["w"], (1, 1), "VALID",
                                 dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                 precision=HI)
    return y + p["b"]


def bn(x, p, s, train):
    """torch BatchNorm2d: biased batch variance to normalize, unbiased
    into the running estimate, momentum 0.1."""
    if train:
        mean, var = jnp.mean(x, (0, 1, 2)), jnp.var(x, (0, 1, 2))
        n = x.shape[0] * x.shape[1] * x.shape[2]
        s = {"mean": 0.9 * s["mean"] + 0.1 * mean,
             "var": 0.9 * s["var"] + 0.1 * var * n / (n - 1)}
    else:
        mean, var = s["mean"], s["var"]
    return (x - mean) / jnp.sqrt(var + 1e-5) * p["scale"] + p["bias"], s


def double_conv(p, s, x, train, rate, key, active):
    y, s1 = bn(conv(x, p["conv1"], True), p["bn1"], s["bn1"], train)
    y, s2 = bn(conv(jnp.maximum(y, 0), p["conv2"], True), p["bn2"],
               s["bn2"], train)
    y = jnp.maximum(y, 0)
    if active and rate > 0:  # Dropout2d: whole feature maps per sample
        keep = jax.random.bernoulli(key, 1 - rate,
                                    (y.shape[0], 1, 1, y.shape[-1]))
        y = jnp.where(keep, y / (1 - rate), 0)
    return y, {"bn1": s1, "bn2": s2}


def pool(x, with_idx):
    b, h, w, c = x.shape
    x = x[:, :h // 2 * 2, :w // 2 * 2]
    win = x.reshape(b, h // 2, 2, w // 2, 2, c).transpose(0, 1, 3, 5, 2, 4)
    win = win.reshape(b, h // 2, w // 2, c, 4)
    return win.max(-1), (jnp.argmax(win, -1) if with_idx else None)


def unpool(x, idx):
    b, h, w, c = x.shape
    y = x[..., None] * jax.nn.one_hot(idx, 4, dtype=x.dtype)
    y = y.reshape(b, h, w, c, 2, 2).transpose(0, 1, 4, 2, 5, 3)
    return y.reshape(b, 2 * h, 2 * w, c)


def up(p, s, x1, x2, idx, mode, train, rate, key, active):
    if mode == "bilinear":
        x1 = _resize_axis_align_corners(x1, 1, 2 * x1.shape[1])
        x1 = _resize_axis_align_corners(x1, 2, 2 * x1.shape[2])
    elif mode == "unpool":
        x1 = unpool(x1, idx)
    else:  # ConvTranspose2d k=2 s=2: each input pixel paints a 2x2 block
        n, h, w, _ = x1.shape
        x1 = jnp.einsum("nijc,abco->niajbo", x1, p["up"]["w"], precision=HI)
        x1 = x1.reshape(n, 2 * h, 2 * w, -1) + p["up"]["b"]
    dy, dx = x2.shape[1] - x1.shape[1], x2.shape[2] - x1.shape[2]
    x1 = jnp.pad(x1, [(0, 0), (dy // 2, dy - dy // 2),
                      (dx // 2, dx - dx // 2), (0, 0)])
    y, st = double_conv(p["conv"], s["conv"], jnp.concatenate([x2, x1], -1),
                        train, rate, key, active)
    return y, {"conv": st}


def plain_apply(params, state, x, cfg, train, rng, mc_dropout=False):
    """The reference MimoUNet.forward (model.py:160-297), one subnetwork
    at a time, with the model's dropout key schedule."""
    s_n, active = cfg.num_subnetworks, train or mc_dropout
    idx_on = cfg.use_pooling_indices
    k_enc, k_core, k_dec = jax.random.split(rng, 3)
    take = lambda tree, i: jax.tree.map(lambda v: v[i], tree)  # noqa: E731
    enc_p, enc_s = params["encoder"], state["encoder"]
    x1s, x2s, ind2s, enc_st = [], [], [], []
    for i, k in enumerate(jax.random.split(k_enc, s_n)):
        k1, k2 = jax.random.split(k)
        p, st = take(enc_p, i), take(enc_s, i)
        x1, st_in = double_conv(p["in_conv"], st["in_conv"], x[:, i], train,
                                cfg.encoder_dropout_rate, k1, active)
        pooled, ind2 = pool(x1, idx_on)
        x2, st_d1 = double_conv(p["down1"], st["down1"], pooled, train,
                                cfg.encoder_dropout_rate, k2, active)
        x1s.append(x1), x2s.append(x2), ind2s.append(ind2)
        enc_st.append({"in_conv": st_in, "down1": st_d1})

    cp, cs, kc = params["core"], state["core"], jax.random.split(k_core, 7)
    core_st, rate = {}, cfg.core_dropout_rate
    h = jnp.concatenate(x2s, -1)
    skips, inds = [h], []
    for j, name in enumerate(("down2", "down3", "down4")):
        pooled, ind = pool(h, idx_on)
        h, core_st[name] = double_conv(cp[name], cs[name], pooled, train,
                                       rate, kc[j], active)
        skips.append(h), inds.append(ind)
    if active and cfg.center_dropout_rate > 0:
        keep = jax.random.bernoulli(kc[3], 1 - cfg.center_dropout_rate,
                                    h.shape)
        h = jnp.where(keep, h / (1 - cfg.center_dropout_rate), 0)
    for j, name in enumerate(("up1", "up2", "up3")):
        h, core_st[name] = up(cp[name], cs[name], h, skips[2 - j],
                              inds[2 - j], cfg.mode, train, rate, kc[4 + j],
                              active)

    logits, dec_st = [], []
    for i, k in enumerate(jax.random.split(k_dec, s_n)):
        k1, k2 = jax.random.split(k)
        p, st = take(params["decoder"], i), take(state["decoder"], i)
        ind2 = ind2s[i]
        if ind2 is not None:  # corrected wiring: tile over the S groups
            ind2 = jnp.tile(ind2, (1, 1, 1, h.shape[-1] // ind2.shape[-1]))
        y, st_up4 = up(p["up4"], st["up4"], h, x1s[i], ind2, cfg.mode,
                       train, cfg.decoder_dropout_rate, k1, active)
        if active and cfg.final_dropout_rate > 0:
            keep = jax.random.bernoulli(k2, 1 - cfg.final_dropout_rate,
                                        y.shape)
            y = jnp.where(keep, y / (1 - cfg.final_dropout_rate), 0)
        logits.append(conv(y, p["outc"], False))
        dec_st.append({"up4": st_up4})

    stack = lambda trees: jax.tree.map(lambda *v: jnp.stack(v), *trees)  # noqa: E731
    new_state = {"encoder": stack(enc_st), "core": core_st,
                 "decoder": stack(dec_st)}
    return jnp.stack(logits, 1), new_state


# ----------------------------------------------------------------- tests

def _cfg(s=2, mode="bilinear", **kw):
    return MimoUNetConfig(in_channels=3, out_channels=2, num_subnetworks=s,
                          filter_base_count=4, bilinear=mode == "bilinear",
                          use_pooling_indices=mode == "unpool", **kw)


def _setup(cfg, b=2, h=32, w=32):
    params, state = mimo_unet_init(jax.random.key(0), cfg)
    # non-trivial running stats, so eval BatchNorm is exercised too
    state = jax.tree.map(
        lambda v: v + 0.1 * jax.random.uniform(jax.random.key(1), v.shape),
        state)
    x = jax.random.uniform(jax.random.key(2),
                           (b, cfg.num_subnetworks, h, w, 3))
    return params, state, x


def _close(got, want, tol, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = scale if scale is not None else max(np.abs(want).max(), 1e-6)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _compare_forward(cfg, train, b=2, h=32, w=32, mc_dropout=False, seed=3):
    params, state, x = _setup(cfg, b, h, w)
    rng = jax.random.key(seed)
    with jax.default_matmul_precision("highest"):
        got, got_st = jax.jit(lambda p, s, v: mimo_unet_apply(
            p, s, v, cfg, train=train, rng=rng, mc_dropout=mc_dropout))(
                params, state, x)
        want, want_st = jax.jit(lambda p, s, v: plain_apply(
            p, s, v, cfg, train, rng, mc_dropout))(params, state, x)
    assert got.shape == (b, cfg.num_subnetworks, h, w, cfg.out_channels)
    # train: batch statistics over as few as 8 values per channel at the
    # 2x2 bottom of the U amplify f32 rounding differences between the two
    # compositions
    tol = TOL_TRAIN if train else 2e-5
    _close(got, want, tol)
    for a, c in zip(jax.tree.leaves(got_st), jax.tree.leaves(want_st)):
        _close(a, c, tol)
    return got


def _compare_grads(cfg, b=2, h=32, w=32):
    params, state, x = _setup(cfg, b, h, w)
    rng = jax.random.key(3)
    label = jax.random.uniform(jax.random.key(4), x.shape[:-1] + (1,))

    def loss(apply):
        def f(p):
            out = apply(p)
            mu, log_b = out[..., :1], out[..., 1:]
            return jnp.mean(log_b + jnp.abs(label - mu) * jnp.exp(-log_b))
        return f

    with jax.default_matmul_precision("highest"):
        got = jax.jit(jax.grad(loss(lambda p: mimo_unet_apply(
            p, state, x, cfg, train=True, rng=rng)[0])))(params)
        want = jax.jit(jax.grad(loss(lambda p: plain_apply(
            p, state, x, cfg, True, rng)[0])))(params)
    scale = max(float(jnp.abs(v).max()) for v in jax.tree.leaves(want))
    for a, c in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        # conv biases ahead of train-mode BN get exactly zero gradient in
        # the model (folded into BN) and rounding noise in the plain form
        _close(a, c, TOL_TRAIN, scale=scale)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("s", [1, 2, 3])
def test_forward_matches_plain(s, train):
    _compare_forward(_cfg(s), train)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("mode", ["transpose", "unpool"])
def test_forward_matches_plain_up_modes(mode, train):
    _compare_forward(_cfg(2, mode), train)


@pytest.mark.parametrize("remat", ["none", "enc", "all"])
def test_grads_match_plain(remat):
    _compare_grads(_cfg(2, remat=remat))


@pytest.mark.parametrize("mode", ["transpose", "unpool"])
def test_grads_match_plain_up_modes(mode):
    _compare_grads(_cfg(2, mode))


@pytest.mark.parametrize("train", [False, True])
def test_frame_proportions_exercise_pad_to_match(train):
    """60x80 (480:640): 30x40 -> 15x20 -> 7x10 -> 3x5 leaves odd heights
    that pad_to_match must fill on the way up."""
    _compare_forward(_cfg(2), train, h=60, w=80)


def test_frame_proportions_grads():
    _compare_grads(_cfg(2), h=60, w=80)


@pytest.mark.parametrize("seed", [0, 1])
def test_mc_spatial_dropout_masks_match_plain(seed):
    """MC dropout at eval (BatchNorm on running stats): the spatial
    dropout masks of every block follow the plain composition's key
    schedule, so outputs agree exactly up to rounding."""
    cfg = _cfg(2, encoder_dropout_rate=0.3, core_dropout_rate=0.3,
               decoder_dropout_rate=0.3)
    out = _compare_forward(cfg, False, mc_dropout=True, seed=seed)
    det = jax.jit(lambda: mimo_unet_apply(
        *_setup(cfg), cfg, train=False)[0])()
    assert not np.allclose(np.asarray(out), np.asarray(det))


def test_legacy_center_and_final_dropout_match_plain():
    cfg = _cfg(2, center_dropout_rate=0.5, final_dropout_rate=0.2)
    _compare_forward(cfg, True)


def test_bf16_forward_close_to_plain_f32():
    cfg = _cfg(2)
    params, state, x = _setup(cfg)
    got, _ = mimo_unet_apply(
        params, state, x, dataclasses.replace(cfg, compute_dtype="bfloat16"),
        train=False)
    with jax.default_matmul_precision("highest"):
        want, _ = plain_apply(params, state, x, cfg, False,
                              jax.random.key(0))
    assert got.dtype == jnp.float32
    rel = float(jnp.linalg.norm(got - want) / jnp.linalg.norm(want))
    assert rel < 3e-2
