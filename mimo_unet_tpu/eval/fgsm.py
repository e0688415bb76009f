"""FGSM adversarial perturbation for robustness evaluation.

Rebuilt from reference scripts/test/test_nyuv2_depth.py:16-24,41-61:
``x' = clip(x + eps * sign(d loss / d x), 0, 1)`` where the loss is the
ensemble NLL against labels repeated across the prediction axis.  Here the
input gradient comes from ``jax.grad`` through the (device-resident)
ensemble forward — which also fixes the reference's broken FGSM-through-
ensemble path (its per-pass .cpu() detaches the graph, ensemble.py:101-102).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from mimo_unet_tpu.transforms import repeat_subnetworks


def fgsm_attack(image: jax.Array, epsilon: float, data_grad: jax.Array) -> jax.Array:
    """Perturb by epsilon along the gradient sign, clipped to [0, 1]."""
    return jnp.clip(image + epsilon * jnp.sign(data_grad), 0.0, 1.0)


def make_fgsm_fn(ensemble, epsilon: float):
    """Build a jitted fn: (image [B,H,W,C], label [B,H,W,C_out], rng) ->
    (perturbed_image, p1, p2) with predictions on the perturbed input."""
    loss_fn = ensemble.loss_fn
    width = ensemble.output_width

    def attack_and_predict(image, label, rng):
        label_rep = repeat_subnetworks(label, width)

        def nll(img):
            p1, p2 = ensemble.raw_forward(img, rng)
            return loss_fn(p1, p2, label_rep)

        if epsilon > 0.0:
            grad = jax.grad(nll)(image)
            image = fgsm_attack(image, epsilon, grad)
        p1, p2 = ensemble.raw_forward(image, rng)
        return image, p1, p2

    return attack_and_predict
