"""Checks that only mean something on a CUDA device.

Marked ``gpu``: each takes the ``gpu_device`` fixture (conftest), which
skips it where JAX has no GPU.  ``chip_smoke.py`` runs them on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mimo_unet_tpu.data.core import device_cache_budget_bytes

pytestmark = pytest.mark.gpu


def test_device_cache_budget_from_memory_stats(gpu_device):
    """The card reports its memory limit, so the device-cache gate gets a
    real budget: 60% of what is free, never a guess."""
    stats = gpu_device.memory_stats()
    budget = device_cache_budget_bytes()
    assert 0 < budget < stats["bytes_limit"]


def test_bf16_conv_accumulates_in_f32(gpu_device):
    """A long bf16 reduction through the conv path the model uses: with
    f32 accumulation the sum of 4096 ones is exact (bf16 accumulation
    would stall at 256)."""
    from mimo_unet_tpu.ops.conv import conv2d

    x = jnp.ones((1, 1, 1, 4096), jnp.bfloat16)
    params = {"w": jnp.ones((1, 1, 4096, 1)), "b": jnp.zeros((1,))}
    y = jax.jit(lambda x, p: conv2d(x, p, compute_dtype=jnp.bfloat16))(
        x, params)
    assert y.dtype == jnp.bfloat16
    assert float(y[0, 0, 0, 0]) == 4096.0


def test_highest_precision_conv_matches_cpu(gpu_device):
    """precision="highest" keeps TF32 out of an f32 conv: one 3x3 reflect
    conv matches the CPU to f32 rounding."""
    from mimo_unet_tpu.ops.conv import conv2d, conv2d_init

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 32, 21)).astype(np.float32)
    params = conv2d_init(jax.random.key(0), 21, 21, 3)
    f = jax.jit(lambda x, p: conv2d(x, p, padding="REFLECT"))
    cpu = jax.devices("cpu")[0]
    with jax.default_matmul_precision("highest"):
        got = np.asarray(f(jax.device_put(x, gpu_device), params))
        want = np.asarray(f(jax.device_put(x, cpu),
                            jax.device_put(params, cpu)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
