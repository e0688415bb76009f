"""Device-memory capacity ladder (train/capacity.py) + remat numerics.

A train step too large for device memory fails its compile; the ladder
retries the compile with jax.checkpoint rematerialization.  Remat must be
a pure memory/compute trade: identical gradients.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mimo_unet_tpu.tasks import MimoUnetTask
from mimo_unet_tpu.train import capacity


def tiny_task(**kw):
    kw.setdefault("filter_base_count", 4)
    return MimoUnetTask(
        in_channels=3, out_channels=2, num_subnetworks=2,
        loss="laplace_nll", seed=0, **kw)


def _batch(b=4, h=16, w=16):
    k1, k2 = jax.random.split(jax.random.key(0))
    return {
        "image": jax.random.uniform(k1, (b, h, w, 3)),
        "label": jax.random.uniform(k2, (b, h, w, 1)),
    }


def _model_grads(cfg, b=4, h=16, w=16):
    """Gradients of a scalar loss through mimo_unet_apply(train=True)."""
    from mimo_unet_tpu.models import mimo_unet_apply, mimo_unet_init

    params, state = mimo_unet_init(jax.random.key(0), cfg)
    x = jax.random.uniform(jax.random.key(1),
                           (b, cfg.num_subnetworks, h, w, 3))

    @jax.jit
    def loss(p):
        out, _ = mimo_unet_apply(p, state, x, cfg, train=True,
                                 rng=jax.random.key(2))
        return jnp.mean(out.astype(jnp.float32) ** 2)

    return loss(params), jax.grad(loss)(params)


class TestRematNumerics:
    @pytest.mark.parametrize("remat", ["enc", "all"])
    def test_grads_match_no_remat(self, remat):
        """jax.checkpoint replays the same ops: gradients must match the
        uncheckpointed forward to fusion-rounding noise (XLA path)."""
        base = tiny_task().model_config
        l0, g0 = _model_grads(base)
        l1, g1 = _model_grads(dataclasses.replace(base, remat=remat))
        np.testing.assert_allclose(float(l0), float(l1), rtol=1e-6)
        for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
            a, b = np.asarray(a), np.asarray(b)
            scale = max(np.abs(a).max(), 1e-8)
            np.testing.assert_allclose(a, b, rtol=1e-4,
                                       atol=1e-5 * scale)


class TestLadder:
    def test_oom_classifier(self):
        assert capacity.is_hbm_oom(RuntimeError(
            "INTERNAL: ... Ran out of memory in memory space hbm. "
            "Used 17.00G of 16.00G hbm."))
        assert capacity.is_hbm_oom(RuntimeError(
            "RESOURCE_EXHAUSTED: allocation failure"))
        assert not capacity.is_hbm_oom(RuntimeError(
            "INVALID_ARGUMENT: unsupported convolution layout"))

    def test_ladder_falls_back_on_hbm_oom(self, monkeypatch):
        """Force the capacity failure mode: rung 'none' OOMs at compile,
        the ladder must return a working remat='enc' step — no
        try/except dropping the batch size."""
        task = tiny_task()
        tx = task.make_optimizer(steps_per_epoch=10)
        state = task.init_state(steps_per_epoch=10)
        batch = _batch()
        rng = jax.random.key(1)

        real_jit = jax.jit
        seen = []

        def fake_jit(fn, **kw):
            jitted = real_jit(fn, **kw)

            class Wrapper:
                def lower(self, *a, **k):
                    lowered = jitted.lower(*a, **k)
                    # the partial closes over the replaced task; read its
                    # remat through the bound __self__
                    remat = fn.func.__self__.remat
                    seen.append(remat)
                    if remat == "none":
                        class Boom:
                            def compile(self_inner):
                                raise RuntimeError(
                                    "Ran out of memory in memory space "
                                    "hbm. Used 17.00G of 16.00G hbm.")
                        return Boom()
                    return lowered

                def __call__(self, *a, **k):
                    return jitted(*a, **k)

            return Wrapper()

        monkeypatch.setattr(capacity.jax, "jit", fake_jit)
        step, used = capacity.make_train_step(
            task, tx, state, batch, rng, verbose=False)
        assert used.remat == "enc"
        assert seen == ["none", "enc"]
        new_state, logs, _ = step(state, batch, rng)
        assert np.isfinite(float(logs["train_loss"]))

    def test_non_capacity_errors_propagate(self, monkeypatch):
        task = tiny_task()
        tx = task.make_optimizer(steps_per_epoch=10)
        state = task.init_state(steps_per_epoch=10)

        def fake_jit(fn, **kw):
            class Wrapper:
                def lower(self, *a, **k):
                    raise RuntimeError("INVALID_ARGUMENT: bad kernel")

            return Wrapper()

        monkeypatch.setattr(capacity.jax, "jit", fake_jit)
        with pytest.raises(RuntimeError, match="bad kernel"):
            capacity.make_train_step(task, tx, state, _batch(),
                                     jax.random.key(1), verbose=False)
