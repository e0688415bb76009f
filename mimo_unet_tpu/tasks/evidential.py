"""Evidential (Normal-Inverse-Gamma) U-Net task.

Rebuilt from reference mimo/models/evidential_unet.py:13-209: a single-
subnetwork MimoUNet with 4 output channels; the forward applies
``v = softplus(logv)``, ``alpha = softplus(logalpha) + 1``,
``beta = softplus(logbeta)`` (:90-94) and training minimizes the NIG
sum-of-squares loss with closed-form aleatoric/epistemic variances.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from mimo_unet_tpu.losses import EvidentialLoss
from mimo_unet_tpu.data.core import device_normalize
from mimo_unet_tpu.loss_buffer import loss_buffer_init
from mimo_unet_tpu.metrics import compute_regression_metrics
from mimo_unet_tpu.models import MimoUNetConfig, count_parameters, mimo_unet_apply, mimo_unet_init
from mimo_unet_tpu.tasks.mimo import TrainState
from mimo_unet_tpu.train.optim import adam_with_steplr


@dataclasses.dataclass(frozen=True)
class EvidentialUnetTask:
    in_channels: int
    out_channels: int = 4
    filter_base_count: int = 32
    center_dropout_rate: float = 0.0
    final_dropout_rate: float = 0.0
    encoder_dropout_rate: float = 0.0
    core_dropout_rate: float = 0.0
    decoder_dropout_rate: float = 0.0
    weight_decay: float = 0.0
    learning_rate: float = 1e-3
    seed: int = 42
    scheduler_step_size: int = 20
    scheduler_gamma: float = 0.5
    compute_dtype: Optional[str] = None
    remat: str = "none"  # memory capacity ladder (train/capacity.py)

    @property
    def model_config(self) -> MimoUNetConfig:
        return MimoUNetConfig(
            in_channels=self.in_channels,
            out_channels=self.out_channels,
            num_subnetworks=1,
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
    def loss_fn(self) -> EvidentialLoss:
        return EvidentialLoss(coeff=1.0)

    def hparams(self) -> dict:
        d = dataclasses.asdict(self)
        d["task"] = "evidential_unet"
        d["loss"] = "evidential"
        return d

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
            loss_buffer=loss_buffer_init(1, 0),  # unused; keeps TrainState uniform
        )

    def trainable_params(self, state: TrainState) -> int:
        return count_parameters(state.params)

    def forward(
        self,
        params: dict,
        model_state: dict,
        x: jax.Array,
        *,
        train: bool,
        rng: Optional[jax.Array] = None,
        mc_dropout: bool = False,
    ) -> Tuple[jax.Array, dict]:
        """x [B,H,W,C_in] -> evidential output [B,H,W,4] = (mu, v, alpha, beta).

        Softplus links per reference evidential_unet.py:90-94.
        """
        out, new_state = mimo_unet_apply(
            params, model_state, x[:, None], self.model_config,
            train=train, rng=rng, mc_dropout=mc_dropout,
        )
        out = out[:, 0]  # drop the singleton subnetwork axis
        mu = out[..., 0]
        v = jax.nn.softplus(out[..., 1])
        alpha = jax.nn.softplus(out[..., 2]) + 1.0
        beta = jax.nn.softplus(out[..., 3])
        return jnp.stack([mu, v, alpha, beta], axis=-1), new_state

    def train_step(
        self,
        tx: optax.GradientTransformation,
        state: TrainState,
        batch: Dict[str, jax.Array],
        rng: jax.Array,
        with_outputs: bool = False,
    ) -> Tuple[TrainState, Dict[str, jax.Array], Optional[Dict[str, jax.Array]]]:
        loss_fn = self.loss_fn
        batch = device_normalize(batch)
        k_dropout = jax.random.fold_in(rng, state.step)
        image, label = batch["image"], batch["label"]
        mask = batch.get("mask")
        mask_sq = jnp.squeeze(mask, axis=-1) if mask is not None else None

        def objective(params):
            out, new_model_state = self.forward(
                params, state.model_state, image, train=True, rng=k_dropout
            )
            loss = loss_fn(out, label, mask=mask_sq, reduce_mean=True)
            return loss, (new_model_state, out)

        (loss, (new_model_state, out)), grads = jax.value_and_grad(
            objective, has_aux=True
        )(state.params)

        updates, new_opt_state = tx.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)
        new_state = TrainState(
            step=state.step + 1,
            params=new_params,
            model_state=new_model_state,
            opt_state=new_opt_state,
            loss_buffer=state.loss_buffer,
        )

        y_pred = loss_fn.mode(out)[..., None]
        logs = {"train_loss": loss}
        for name, value in compute_regression_metrics(y_pred, label).items():
            logs[f"metric_train/{name}"] = value

        outputs = None
        if with_outputs:
            aleatoric_std = jnp.sqrt(loss_fn.aleatoric_var(out))[..., None]
            outputs = {
                "label": label,
                "preds": y_pred,
                "aleatoric_std_map": aleatoric_std,
                "err_map": y_pred - label,
                "mask": mask,
            }
        return new_state, logs, outputs

    def val_step(
        self,
        params: dict,
        model_state: dict,
        batch: Dict[str, jax.Array],
    ) -> Tuple[Dict[str, jax.Array], Dict[str, jax.Array]]:
        loss_fn = self.loss_fn
        batch = device_normalize(batch)
        image, label = batch["image"], batch["label"]
        mask = batch.get("mask")
        mask_sq = jnp.squeeze(mask, axis=-1) if mask is not None else None
        valid = batch.get("valid")  # [B] 0/1: pad rows get weight 0 (see mimo.py)

        def wmean(x):
            if valid is None:
                return jnp.mean(x)
            w = valid.astype(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
            return jnp.sum(x * w) / (jnp.sum(valid) * (x.size // x.shape[0]))

        out, _ = self.forward(params, model_state, image, train=False)
        loss = loss_fn(out, label, mask=mask_sq, reduce_mean=False)

        y_pred = loss_fn.mode(out)[..., None]
        aleatoric_std = jnp.sqrt(loss_fn.aleatoric_var(out))[..., None]
        epistemic_std = jnp.sqrt(loss_fn.epistemic_var(out))[..., None]

        row_w = None if valid is None else valid.reshape(
            (-1,) + (1,) * (label.ndim - 1)
        )
        logs = {
            "val_loss": wmean(loss),
            "metric_val/aleatoric_std_mean": wmean(jnp.clip(aleatoric_std, 0, 5)),
            "metric_val/epistemic_std_mean": wmean(jnp.clip(epistemic_std, 0, 5)),
        }
        for name, value in compute_regression_metrics(
            y_pred, label, weights=row_w
        ).items():
            logs[f"metric_val/{name}"] = value

        outputs = {
            "label": label,
            "preds": y_pred,
            "aleatoric_std_map": aleatoric_std,
            "epistemic_std_map": epistemic_std,
            "err_map": y_pred - label,
            "mask": mask,
        }
        return logs, outputs
