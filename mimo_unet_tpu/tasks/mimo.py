"""MIMO U-Net training task: the reference's LightningModule semantics as
pure jitted step functions.

Rebuilt from reference mimo/models/mimo_unet.py:15-314:
  * forward (:93-113): run MimoUNet, split the channel axis into p1 (means)
    and p2 (log-params) halves.
  * training_step (:115-144): input transform -> forward -> per-subnetwork
    NLL mean over (batch, spatial, channel) -> loss-buffer weighting ->
    weighted mean; logs per-subnetwork losses/weights + regression metrics.
  * validation_step (:146-183): repeat inputs across subnetworks, per-
    subnetwork val loss, uncertainty decomposition, "combined" NLL with the
    combined std re-encoded through calculate_dist_param(log=True).
  * configure_optimizers (:185-201): Adam + StepLR(20, 0.5).

Differences from the reference: the whole train step (including the loss-buffer ring
and metric computation) is one jitted program over carried ``TrainState``;
no host round-trips.  The batch axis may be sharded over a device mesh —
all math is global-batch, so XLA inserts the collectives (BatchNorm included,
matching the reference's single-device global-batch stats).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from mimo_unet_tpu.losses import UncertaintyLoss
from mimo_unet_tpu.data.core import device_normalize
from mimo_unet_tpu.loss_buffer import (
    LossBufferState,
    loss_buffer_add,
    loss_buffer_init,
    loss_buffer_weights,
)
from mimo_unet_tpu.metrics import compute_regression_metrics
from mimo_unet_tpu.models import (
    MimoUNetConfig,
    count_parameters,
    mimo_unet_apply,
    mimo_unet_init,
)
from mimo_unet_tpu.train.optim import adam_with_steplr
from mimo_unet_tpu.transforms import (
    apply_input_transform,
    compute_uncertainties,
    flatten_subnetwork_dimension,
    repeat_subnetworks,
)


class TrainState(NamedTuple):
    """Everything a train step carries, as one pytree."""

    step: jax.Array  # scalar int32
    params: dict
    model_state: dict  # batch-norm running stats
    opt_state: optax.OptState
    loss_buffer: LossBufferState


@dataclasses.dataclass(frozen=True)
class MimoUnetTask:
    """Hyperparameters + pure step functions for MIMO U-Net training.

    Field names mirror the reference CLI flags (mimo_unet.py:293-314), which
    are this framework's public API too.
    """

    in_channels: int
    out_channels: int
    num_subnetworks: int
    filter_base_count: int
    center_dropout_rate: float = 0.0
    final_dropout_rate: float = 0.0
    encoder_dropout_rate: float = 0.0
    core_dropout_rate: float = 0.0
    decoder_dropout_rate: float = 0.0
    loss: str = "laplace_nll"
    weight_decay: float = 0.0
    learning_rate: float = 1e-3
    seed: int = 42
    loss_buffer_size: int = 10
    loss_buffer_temperature: float = 1.0
    input_repetition_probability: float = 0.0
    batch_repetitions: int = 1
    scheduler_step_size: int = 20
    scheduler_gamma: float = 0.5
    compute_dtype: Optional[str] = None
    remat: str = "none"  # memory capacity ladder (train/capacity.py)

    # ------------------------------------------------------------------ config

    @property
    def model_config(self) -> MimoUNetConfig:
        return MimoUNetConfig(
            in_channels=self.in_channels,
            out_channels=self.out_channels,
            num_subnetworks=self.num_subnetworks,
            filter_base_count=self.filter_base_count,
            center_dropout_rate=self.center_dropout_rate,
            final_dropout_rate=self.final_dropout_rate,
            encoder_dropout_rate=self.encoder_dropout_rate,
            core_dropout_rate=self.core_dropout_rate,
            decoder_dropout_rate=self.decoder_dropout_rate,
            bilinear=True,
            use_pooling_indices=False,
            compute_dtype=self.compute_dtype,
            remat=self.remat,
        )

    @property
    def loss_fn(self) -> UncertaintyLoss:
        return UncertaintyLoss.from_name(self.loss)

    def hparams(self) -> dict:
        """JSON-serializable hyperparameters (the checkpoint-carries-hparams
        contract the reference relies on via save_hyperparameters)."""
        d = dataclasses.asdict(self)
        d["task"] = "mimo_unet"
        return d

    # ------------------------------------------------------------- init / optim

    def make_optimizer(self, steps_per_epoch: int) -> optax.GradientTransformation:
        return adam_with_steplr(
            self.learning_rate,
            self.weight_decay,
            self.scheduler_step_size,
            self.scheduler_gamma,
            steps_per_epoch,
        )

    def init_state(self, steps_per_epoch: int, rng: Optional[jax.Array] = None) -> TrainState:
        if rng is None:
            rng = jax.random.key(self.seed)
        params, model_state = mimo_unet_init(rng, self.model_config)
        tx = self.make_optimizer(steps_per_epoch)
        return TrainState(
            step=jnp.zeros((), jnp.int32),
            params=params,
            model_state=model_state,
            opt_state=tx.init(params),
            loss_buffer=loss_buffer_init(self.num_subnetworks, self.loss_buffer_size),
        )

    def trainable_params(self, state: TrainState) -> int:
        return count_parameters(state.params)

    # ---------------------------------------------------------------- forward

    def forward(
        self,
        params: dict,
        model_state: dict,
        x: jax.Array,
        *,
        train: bool,
        rng: Optional[jax.Array] = None,
        mc_dropout: bool = False,
    ) -> Tuple[Tuple[jax.Array, jax.Array], dict]:
        """x [B,S,H,W,C_in] -> ((p1, p2) each [B,S,H,W,C_out/2], new_state)."""
        out, new_state = mimo_unet_apply(
            params, model_state, x, self.model_config,
            train=train, rng=rng, mc_dropout=mc_dropout,
        )
        c = self.out_channels // 2
        return (out[..., :c], out[..., c:]), new_state

    # ------------------------------------------------------------- train step

    def loss_and_grads(
        self,
        state: TrainState,
        batch: Dict[str, jax.Array],
        rng: jax.Array,
    ):
        """The train step's objective, differentiated: returns (grads,
        (loss_vec, weights, new_model_state, p1, p2, label_t, mask_t)),
        with ``loss_vec`` the per-subnetwork losses and ``weights`` their
        loss-buffer weights."""
        loss_fn = self.loss_fn
        batch = device_normalize(batch)
        k_transform, k_dropout = jax.random.split(jax.random.fold_in(rng, state.step))

        image_t, label_t, mask_t = apply_input_transform(
            k_transform,
            batch["image"],
            batch["label"],
            batch.get("mask"),
            num_subnetworks=self.num_subnetworks,
            input_repetition_probability=self.input_repetition_probability,
            batch_repetitions=self.batch_repetitions,
        )

        def objective(params):
            (p1, p2), new_model_state = self.forward(
                params, state.model_state, image_t, train=True, rng=k_dropout
            )
            # per-subnetwork loss: mean over (batch, H, W, channel), keep S
            per_px = loss_fn(p1, p2, label_t, mask=mask_t, reduce_mean=False)
            loss_vec = jnp.mean(per_px, axis=(0, 2, 3, 4))
            weights = loss_buffer_weights(
                state.loss_buffer, self.loss_buffer_temperature, self.loss_buffer_size
            )
            loss_weighted = jnp.mean(loss_vec * weights)
            return loss_weighted, (loss_vec, weights, new_model_state, p1, p2)

        grads, aux = jax.grad(objective, has_aux=True)(state.params)
        return grads, aux + (label_t, mask_t)

    def train_step(
        self,
        tx: optax.GradientTransformation,
        state: TrainState,
        batch: Dict[str, jax.Array],
        rng: jax.Array,
        with_outputs: bool = False,
    ) -> Tuple[TrainState, Dict[str, jax.Array], Optional[Dict[str, jax.Array]]]:
        """One optimization step.  ``batch``: image/label [B,H,W,C], optional
        mask [B,H,W,1].  Returns (new_state, logs, outputs-or-None)."""
        loss_fn = self.loss_fn
        grads, (loss_vec, weights, new_model_state, p1, p2, label_t,
                mask_t) = self.loss_and_grads(state, batch, rng)

        updates, new_opt_state = tx.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)
        new_buffer = loss_buffer_add(
            state.loss_buffer, loss_vec, self.loss_buffer_size
        )
        new_state = TrainState(
            step=state.step + 1,
            params=new_params,
            model_state=new_model_state,
            opt_state=new_opt_state,
            loss_buffer=new_buffer,
        )

        y_pred = loss_fn.mode(p1, p2)
        logs = {"train_loss": jnp.mean(loss_vec)}
        for i in range(self.num_subnetworks):
            logs[f"train_loss_{i}"] = loss_vec[i]
            logs[f"train_weight_{i}"] = weights[i]
        for name, value in compute_regression_metrics(y_pred, label_t).items():
            logs[f"metric_train/{name}"] = value

        outputs = None
        if with_outputs:
            aleatoric_std = loss_fn.std(p1, p2)
            outputs = {
                "label": flatten_subnetwork_dimension(label_t),
                "preds": flatten_subnetwork_dimension(y_pred),
                "aleatoric_std_map": flatten_subnetwork_dimension(aleatoric_std),
                "err_map": flatten_subnetwork_dimension(y_pred - label_t),
                "mask": (
                    flatten_subnetwork_dimension(mask_t) if mask_t is not None else None
                ),
            }
        return new_state, logs, outputs

    # --------------------------------------------------------------- val step

    def val_step(
        self,
        params: dict,
        model_state: dict,
        batch: Dict[str, jax.Array],
    ) -> Tuple[Dict[str, jax.Array], Dict[str, jax.Array]]:
        """Validation step (no state mutation).  Returns (logs, outputs).

        ``batch`` may carry ``valid`` [B] (0/1): rows padded on so the batch
        divides the device mesh get weight 0 in every logged statistic (the
        reference never pads — Lightning weights ``self.log`` by true batch
        size, mimo/models/mimo_unet.py:283-291 — so padding must be a no-op).
        """
        loss_fn = self.loss_fn
        batch = device_normalize(batch)
        image = repeat_subnetworks(batch["image"], self.num_subnetworks)
        label = repeat_subnetworks(batch["label"], self.num_subnetworks)
        mask = batch.get("mask")
        mask_t = (
            repeat_subnetworks(mask, self.num_subnetworks) if mask is not None else None
        )
        valid = batch.get("valid")  # [B] 0/1 row validity

        def wmean(x):
            """Scalar mean of ``x`` over valid batch rows only."""
            if valid is None:
                return jnp.mean(x)
            w = valid.astype(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
            return jnp.sum(x * w) / (jnp.sum(valid) * (x.size // x.shape[0]))

        (p1, p2), _ = self.forward(params, model_state, image, train=False)

        per_px = loss_fn(p1, p2, label, mask=mask_t, reduce_mean=False)
        if valid is None:
            val_loss = jnp.mean(per_px, axis=(0, 2, 3, 4))
        else:
            w = valid.astype(per_px.dtype)[:, None, None, None, None]
            n_elem = per_px.shape[2] * per_px.shape[3] * per_px.shape[4]
            val_loss = jnp.sum(per_px * w, axis=(0, 2, 3, 4)) / (
                jnp.sum(valid) * n_elem
            )

        y_pred_mean, aleatoric_var, epistemic_var = compute_uncertainties(
            loss_fn, p1, p2
        )
        y_mean = jnp.mean(label, axis=1)

        combined_var = aleatoric_var + epistemic_var
        combined_std = jnp.sqrt(combined_var)
        aleatoric_std = jnp.sqrt(aleatoric_var)
        epistemic_std = jnp.sqrt(epistemic_var)

        combined_log_param = loss_fn.calculate_dist_param(std=combined_std, log=True)
        val_loss_combined = wmean(
            loss_fn(
                jnp.mean(p1, axis=1), combined_log_param, y_mean, mask=mask,
                reduce_mean=False,
            )
        )

        row_w = None if valid is None else valid.reshape(
            (-1,) + (1,) * (y_mean.ndim - 1)
        )
        logs = {
            "val_loss": jnp.mean(val_loss),
            "val_loss_combined": val_loss_combined,
            "metric_val/aleatoric_std_mean": wmean(jnp.clip(aleatoric_std, 0, 5)),
            "metric_val/epistemic_std_mean": wmean(jnp.clip(epistemic_std, 0, 5)),
        }
        for i in range(self.num_subnetworks):
            logs[f"val_loss_{i}"] = val_loss[i]
        for name, value in compute_regression_metrics(
            y_pred_mean, y_mean, weights=row_w
        ).items():
            logs[f"metric_val/{name}"] = value

        outputs = {
            "label": y_mean,
            "preds": y_pred_mean,
            "aleatoric_std_map": aleatoric_std,
            "epistemic_std_map": epistemic_std,
            "err_map": y_pred_mean - y_mean,
            "mask": mask,
        }
        return logs, outputs
