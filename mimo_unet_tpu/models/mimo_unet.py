"""MIMO U-Net: per-subnetwork encoders/decoders around a shared core.

Functional rebuild of the reference architecture (reference:
mimo/models/mimo_components/model.py:26-297).  Where the reference loops
Python ``nn.ModuleList``s over the S subnetworks (model.py:167-173,
:292-295), here the per-subnetwork encoder/decoder parameters are stored
with a leading ``[S, ...]`` axis and applied under ``jax.vmap`` — one fused
XLA program with S as a batched dimension.  Per-subnetwork BatchNorm
statistics fall out naturally: inside the vmap each instance reduces over
its own (B, H, W).

Architecture (shape trace in SURVEY.md §3.2, F=filter_base_count, S=subnets):
  encoder (per s):  in_conv DoubleConv(C_in->F), down1 Down(F->2F)
  concat:           [B, H/2, W/2, 2FS]  (channel order = subnetwork-major,
                    matching torch.cat(x2s, axis=1), model.py:113)
  core:             down2 (2FS->4FS), down3 (4FS->8FS), down4 (8FS->16FS/f),
                    center dropout, up1 (16FS->8FS/f), up2 (8FS->4FS/f),
                    up3 (4FS->2FS/f)           [f=2 if bilinear or unpool]
  decoder (per s):  up4 Up(2FS/f + F -> F), final dropout, outc 1x1 (F->C_out)

Input/output are NHWC with the MIMO axis at position 1:
  x [B, S, H, W, C_in]  ->  out [B, S, H, W, C_out].
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from mimo_unet_tpu.models.blocks import (
    double_conv_apply,
    double_conv_init,
    down_apply,
    down_init,
    out_conv_apply,
    out_conv_init,
    up_apply,
    up_init,
    up_mode,
)
from mimo_unet_tpu.ops import dropout
from mimo_unet_tpu.ops.pooling import max_pool_2x2_skip


@dataclasses.dataclass(frozen=True)
class MimoUNetConfig:
    in_channels: int
    out_channels: int
    num_subnetworks: int
    filter_base_count: int = 30
    center_dropout_rate: float = 0.0
    final_dropout_rate: float = 0.0
    encoder_dropout_rate: float = 0.0
    core_dropout_rate: float = 0.0
    decoder_dropout_rate: float = 0.0
    bilinear: bool = True
    use_pooling_indices: bool = False
    # None -> f32 compute; "bfloat16" -> bf16 operands with f32
    # accumulation (the analog of the reference's "16-mixed" AMP).
    compute_dtype: Optional[str] = None
    # Rematerialization (jax.checkpoint) for the train forward — the
    # device-memory capacity ladder (train/capacity.py): "none" saves every
    # residual; "enc" recomputes the per-subnetwork encoders in the backward
    # (the full-res residuals dominate memory at large batch); "all" additionally
    # recomputes the core and decoders.  Numerics are identical (same ops
    # replayed); cost is the extra forward FLOPs of the wrapped sections.
    remat: str = "none"

    def __post_init__(self):
        spatial = (
            self.encoder_dropout_rate > 0.0
            or self.core_dropout_rate > 0.0
            or self.decoder_dropout_rate > 0.0
        )
        legacy = self.center_dropout_rate > 0.0 or self.final_dropout_rate > 0.0
        if spatial and legacy:
            raise ValueError(
                "Do not specify spatial_dropout together with "
                "center_dropout_rate or final_dropout_rate!"
            )
        # Non-bilinear configs run with CORRECTED decoder channel math:
        # the reference's own decoder Up is constructed with post-concat
        # channels but applied pre-concat (ConvTranspose2d channel
        # mismatch / MaxUnpool2d indices channel mismatch,
        # components.py:96-108 + model.py:262-294 — it crashes for every
        # such config, which is why its public task API hardcodes
        # bilinear=True).  Here up4's transpose takes the core's actual
        # 2FS output (halving it to FS before the skip concat), and the
        # unpool decoder tiles each subnetwork's down1 indices across the
        # S channel groups of the shared core output.  Deviation
        # documented in docs/MIGRATION.md ("Corrected, not reproduced").

    @property
    def factor(self) -> int:
        return 2 if (self.bilinear or self.use_pooling_indices) else 1

    @property
    def mode(self) -> str:
        return up_mode(self.bilinear, self.use_pooling_indices)

    @property
    def _compute_dtype(self):
        return jnp.bfloat16 if self.compute_dtype == "bfloat16" else None


def mimo_unet_init(key: jax.Array, cfg: MimoUNetConfig) -> Tuple[dict, dict]:
    """Returns (params, state) pytrees.

    Encoder/decoder leaves carry a leading [S] axis (stacked via vmapped
    init over independent keys); core leaves are unstacked.
    """
    f, s = cfg.filter_base_count, cfg.num_subnetworks
    k_enc, k_core, k_dec = jax.random.split(key, 3)

    # --- per-subnetwork encoder: stack params on a leading S axis
    def init_encoder(k):
        k1, k2 = jax.random.split(k)
        in_conv = double_conv_init(k1, cfg.in_channels, f)
        down1 = down_init(k2, f, 2 * f)
        return {"in_conv": in_conv[0], "down1": down1[0]}, {
            "in_conv": in_conv[1],
            "down1": down1[1],
        }

    enc_params, enc_state = jax.vmap(init_encoder)(jax.random.split(k_enc, s))

    # --- shared core
    fs, factor = f * s, cfg.factor
    ks = jax.random.split(k_core, 6)
    core_inits = {
        "down2": down_init(ks[0], 2 * fs, 4 * fs),
        "down3": down_init(ks[1], 4 * fs, 8 * fs),
        "down4": down_init(ks[2], 8 * fs, 16 * fs // factor),
        "up1": up_init(ks[3], 16 * fs, 8 * fs // factor, cfg.mode),
        "up2": up_init(ks[4], 8 * fs, 4 * fs // factor, cfg.mode),
        "up3": up_init(ks[5], 4 * fs, 2 * fs // factor, cfg.mode),
    }
    core_params = {name: p for name, (p, _) in core_inits.items()}
    core_state = {name: st for name, (_, st) in core_inits.items()}

    # --- per-subnetwork decoder
    def init_decoder(k):
        k1, k2 = jax.random.split(k)
        if cfg.mode == "transpose":
            # corrected math: the transpose consumes the core's actual
            # 2FS output and halves it; conv input is FS + F (the
            # reference declares 2FS + F for both and crashes —
            # components.py:97-99 + model.py:265)
            up4 = up_init(k1, fs + f, f, cfg.mode, x1_channels=2 * fs)
        else:
            up4 = up_init(k1, 2 * fs // factor + f, f, cfg.mode)
        outc = out_conv_init(k2, f, cfg.out_channels)
        return {"up4": up4[0], "outc": outc}, {"up4": up4[1]}

    dec_params, dec_state = jax.vmap(init_decoder)(jax.random.split(k_dec, s))

    params = {"encoder": enc_params, "core": core_params, "decoder": dec_params}
    state = {"encoder": enc_state, "core": core_state, "decoder": dec_state}
    return params, state


def mimo_unet_apply(
    params: dict,
    state: dict,
    x: jax.Array,
    cfg: MimoUNetConfig,
    *,
    train: bool,
    rng: Optional[jax.Array] = None,
    mc_dropout: bool = False,
) -> Tuple[jax.Array, dict]:
    """Forward pass: [B, S, H, W, C_in] -> ([B, S, H, W, C_out], new_state).

    ``rng`` drives every dropout site; required when dropout is active
    (train with nonzero rates, or ``mc_dropout=True`` at eval — the analog
    of the reference's MC-dropout reactivation, ensemble.py:54-66).
    """
    s = cfg.num_subnetworks
    assert x.ndim == 5 and x.shape[1] == s, (
        "expected [B, S, H, W, C] with S == num_subnetworks"
    )
    assert x.shape[-1] == cfg.in_channels, "channel dim must match in_channels"
    dropout_active = mc_dropout or train
    has_dropout = any(
        r > 0
        for r in (
            cfg.center_dropout_rate,
            cfg.final_dropout_rate,
            cfg.encoder_dropout_rate,
            cfg.core_dropout_rate,
            cfg.decoder_dropout_rate,
        )
    )
    if dropout_active and has_dropout and rng is None:
        raise ValueError("rng is required when dropout is active")
    if rng is None:
        rng = jax.random.key(0)  # unused: every dropout site is a no-op

    k_enc, k_core, k_dec = jax.random.split(rng, 3)
    (x1s, x2s, ind2s), enc_state = encoder_apply(
        params["encoder"], state["encoder"], x, cfg, train=train, rng=k_enc,
        mc_dropout=mc_dropout)

    # concat the S encodings subnetwork-major on channels:
    # [S, B, H/2, W/2, 2F] -> [B, H/2, W/2, S*2F]
    x2_concat = jnp.moveaxis(x2s, 0, -2)
    x2_concat = x2_concat.reshape(x2_concat.shape[:-2] + (-1,))

    # ----- shared core -------------------------------------------------------
    def core_fn(cp, cs, xc, kc):
        return core_apply(
            cp, cs, xc, cfg, train=train, rng=kc, mc_dropout=mc_dropout,
            dropout_active=dropout_active,
        )

    if train and cfg.remat == "all":
        core_fn = jax.checkpoint(core_fn)
    x_up, core_st = core_fn(params["core"], state["core"], x2_concat, k_core)

    logits, dec_state = decoder_apply(
        params["decoder"], state["decoder"], x_up, x1s, ind2s, cfg,
        train=train, rng=k_dec, mc_dropout=mc_dropout,
        dropout_active=dropout_active)

    new_state = {"encoder": enc_state, "core": core_st, "decoder": dec_state}
    # [S, B, H, W, C_out] -> [B, S, H, W, C_out]; model output is the loss
    # boundary, so upcast bf16 activations back to f32 here.
    return jnp.moveaxis(logits, 0, 1).astype(jnp.float32), new_state


def encoder_apply(
    params: dict,
    state: dict,
    x: jax.Array,
    cfg: MimoUNetConfig,
    *,
    train: bool,
    rng: jax.Array,
    mc_dropout: bool = False,
):
    """Per-subnetwork encoders (in_conv, down1), vmapped over S:
    x [B, S, H, W, C_in] -> ((x1s, x2s, ind2s) each with a leading [S]
    axis, new encoder state).  ``params``/``state`` are the model's
    "encoder" subtrees."""
    cdt = cfg._compute_dtype

    def encoder_one(p, st, xs, k):
        k1, k2 = jax.random.split(k)
        x1, st_in = double_conv_apply(
            p["in_conv"], st["in_conv"], xs, train=train,
            dropout_rate=cfg.encoder_dropout_rate, dropout_key=k1,
            mc_dropout=mc_dropout, compute_dtype=cdt,
        )
        (x2, ind2), st_d1 = down_apply(
            p["down1"], st["down1"], x1, train=train,
            use_pooling_indices=cfg.use_pooling_indices,
            dropout_rate=cfg.encoder_dropout_rate, dropout_key=k2,
            mc_dropout=mc_dropout, compute_dtype=cdt,
        )
        return (x1, x2, ind2), {"in_conv": st_in, "down1": st_d1}

    if train and cfg.remat in ("enc", "all"):
        encoder_one = jax.checkpoint(encoder_one)
    return jax.vmap(encoder_one, in_axes=(0, 0, 1, 0), out_axes=0)(
        params, state, x, jax.random.split(rng, cfg.num_subnetworks))


def decoder_apply(
    params: dict,
    state: dict,
    x_up: jax.Array,
    x1s: jax.Array,
    ind2s: Optional[jax.Array],
    cfg: MimoUNetConfig,
    *,
    train: bool,
    rng: jax.Array,
    mc_dropout: bool = False,
    dropout_active: bool = False,
):
    """Per-subnetwork decoders (up4, final dropout, outc), vmapped over S:
    the shared core output ``x_up`` [B, H/2, W/2, ·] plus each
    subnetwork's full-resolution skip ``x1s`` [S, B, H, W, F] ->
    (logits [S, B, H, W, C_out], new decoder state)."""
    cdt = cfg._compute_dtype

    def decoder_one(p, st, x1, ind2, k):
        k1, k2 = jax.random.split(k)
        if cfg.use_pooling_indices and ind2 is not None:
            # corrected math: this subnetwork's down1 pooling pattern
            # (F channels) applies to every S-group of the shared core
            # output (FS channels) — the reference feeds the F-channel
            # indices straight into an FS-channel MaxUnpool2d and
            # crashes for S > 1 (model.py:292-294)
            reps = x_up.shape[-1] // ind2.shape[-1]
            if reps > 1:
                ind2 = jnp.tile(ind2, (1, 1, 1, reps))
        y, st_up4 = up_apply(
            p["up4"], st["up4"], x_up, x1, ind2, mode=cfg.mode, train=train,
            dropout_rate=cfg.decoder_dropout_rate, dropout_key=k1,
            mc_dropout=mc_dropout, compute_dtype=cdt,
        )
        y = dropout(y, cfg.final_dropout_rate, k2,
                    deterministic=not dropout_active)
        y = out_conv_apply(p["outc"], y, compute_dtype=cdt)
        return y, {"up4": st_up4}

    if train and cfg.remat == "all":
        decoder_one = jax.checkpoint(decoder_one)
    return jax.vmap(decoder_one, in_axes=(0, 0, 0, 0, 0), out_axes=0)(
        params, state, x1s, ind2s,
        jax.random.split(rng, cfg.num_subnetworks))


def core_apply(
    params: dict,
    state: dict,
    x2_concat: jax.Array,
    cfg: MimoUNetConfig,
    *,
    train: bool,
    rng: jax.Array,
    mc_dropout: bool = False,
    dropout_active: bool = False,
) -> Tuple[jax.Array, dict]:
    """Shared core (down2..up3, reference model.py:178-243): the NHWC
    section between the per-subnetwork encoder concat and the decoders."""
    cdt = cfg._compute_dtype
    kc = jax.random.split(rng, 7)
    core_st = {}
    # Each Down input here also feeds an Up block's skip; pooling through
    # max_pool_2x2_skip and routing the skip consumer through the returned
    # identity fuses the two consumers' cotangent add into the pool
    # backward's mask fusion (ops/pooling.py).  Indices mode keeps the
    # in-block pool (the unpool path needs them).
    fuse_skip = not cfg.use_pooling_indices

    def _pool_skip(x):
        if fuse_skip:
            return max_pool_2x2_skip(x)
        return x, x

    p2, x2_id = _pool_skip(x2_concat)
    (x3, ind3), core_st["down2"] = down_apply(
        params["down2"], state["down2"], p2, train=train,
        use_pooling_indices=cfg.use_pooling_indices,
        dropout_rate=cfg.core_dropout_rate, dropout_key=kc[0],
        mc_dropout=mc_dropout, compute_dtype=cdt, pre_pooled=fuse_skip,
    )
    p3, x3_id = _pool_skip(x3)
    (x4, ind4), core_st["down3"] = down_apply(
        params["down3"], state["down3"], p3, train=train,
        use_pooling_indices=cfg.use_pooling_indices,
        dropout_rate=cfg.core_dropout_rate, dropout_key=kc[1],
        mc_dropout=mc_dropout, compute_dtype=cdt, pre_pooled=fuse_skip,
    )
    p4, x4_id = _pool_skip(x4)
    (x5, ind5), core_st["down4"] = down_apply(
        params["down4"], state["down4"], p4, train=train,
        use_pooling_indices=cfg.use_pooling_indices,
        dropout_rate=cfg.core_dropout_rate, dropout_key=kc[2],
        mc_dropout=mc_dropout, compute_dtype=cdt, pre_pooled=fuse_skip,
    )
    x5 = dropout(x5, cfg.center_dropout_rate, kc[3],
                 deterministic=not dropout_active)
    x_up, core_st["up1"] = up_apply(
        params["up1"], state["up1"], x5, x4_id, ind5,
        mode=cfg.mode, train=train, dropout_rate=cfg.core_dropout_rate,
        dropout_key=kc[4], mc_dropout=mc_dropout, compute_dtype=cdt,
        split_skip_conv=True,
    )
    x_up, core_st["up2"] = up_apply(
        params["up2"], state["up2"], x_up, x3_id, ind4,
        mode=cfg.mode, train=train, dropout_rate=cfg.core_dropout_rate,
        dropout_key=kc[5], mc_dropout=mc_dropout, compute_dtype=cdt,
        split_skip_conv=True,
    )
    x_up, core_st["up3"] = up_apply(
        params["up3"], state["up3"], x_up, x2_id, ind3,
        mode=cfg.mode, train=train, dropout_rate=cfg.core_dropout_rate,
        dropout_key=kc[6], mc_dropout=mc_dropout, compute_dtype=cdt,
        split_skip_conv=True,
    )
    return x_up, core_st


def count_parameters(params: dict) -> int:
    """Total trainable parameter count (reference mimo/utils.py:13-14)."""
    return sum(int(x.size) for x in jax.tree.leaves(params))
