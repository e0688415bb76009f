"""Task layer + trainer end-to-end tests on synthetic data (CPU mesh)."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mimo_unet_tpu.tasks import EvidentialUnetTask, MimoUnetTask
from mimo_unet_tpu.train.checkpoint import load_checkpoint, save_checkpoint
from mimo_unet_tpu.train.optim import step_lr_schedule


def tiny_task(**kw):
    base = dict(
        in_channels=3,
        out_channels=2,
        num_subnetworks=2,
        filter_base_count=4,
        loss="laplace_nll",
        seed=0,
    )
    base.update(kw)
    return MimoUnetTask(**base)


def synthetic_batch(rng, b=8, h=32, w=32, c_in=3, c_out=1, with_mask=False):
    image = rng.uniform(size=(b, h, w, c_in)).astype(np.float32)
    label = image.mean(axis=-1, keepdims=True).astype(np.float32)[..., :c_out]
    batch = {"image": jnp.asarray(image), "label": jnp.asarray(label)}
    if with_mask:
        batch["mask"] = jnp.asarray(
            (rng.uniform(size=(b, h, w, 1)) > 0.2).astype(np.float32)
        )
    return batch


class TestStepLR:
    def test_epoch_floored_decay(self):
        sched = step_lr_schedule(1e-3, step_size=2, gamma=0.5, steps_per_epoch=10)
        assert sched(0) == 1e-3
        assert sched(19) == 1e-3  # epoch 1 < step_size
        assert sched(20) == 5e-4  # epoch 2
        assert sched(59) == 2.5e-4  # epoch 5


class TestMimoTrainStep:
    def test_loss_decreases(self, rng):
        task = tiny_task()
        tx = task.make_optimizer(steps_per_epoch=10)
        state = task.init_state(steps_per_epoch=10)
        batch = synthetic_batch(rng)
        key = jax.random.key(0)

        import functools

        step = jax.jit(functools.partial(task.train_step, tx, with_outputs=False))
        first = None
        for _ in range(30):
            state, logs, _ = step(state, batch, key)
            if first is None:
                first = float(logs["train_loss"])
        last = float(logs["train_loss"])
        assert last < first, (first, last)
        assert int(state.step) == 30

    def test_logs_and_outputs_schema(self, rng):
        task = tiny_task(loss_buffer_size=4)
        tx = task.make_optimizer(10)
        state = task.init_state(10)
        batch = synthetic_batch(rng, with_mask=True)
        state, logs, outputs = task.train_step(
            tx, state, batch, jax.random.key(0), with_outputs=True
        )
        for k in (
            "train_loss", "train_loss_0", "train_loss_1",
            "train_weight_0", "train_weight_1",
            "metric_train/r2", "metric_train/mae", "metric_train/mse",
            "metric_train/rmse",
        ):
            assert k in logs, k
        # outputs flattened over the S axis
        assert outputs["preds"].shape == (16, 32, 32, 1)
        assert outputs["mask"].shape == (16, 32, 32, 1)
        # loss buffer recorded this step
        assert float(jnp.abs(state.loss_buffer.buffer).sum()) > 0

    def test_val_step_schema(self, rng):
        task = tiny_task()
        state = task.init_state(10)
        batch = synthetic_batch(rng)
        logs, outputs = task.val_step(state.params, state.model_state, batch)
        for k in (
            "val_loss", "val_loss_0", "val_loss_1", "val_loss_combined",
            "metric_val/r2", "metric_val/aleatoric_std_mean",
            "metric_val/epistemic_std_mean",
        ):
            assert k in logs, k
        assert outputs["preds"].shape == (8, 32, 32, 1)
        assert outputs["epistemic_std_map"].shape == (8, 32, 32, 1)
        # epistemic variance must be nonzero for S=2 with random init
        assert float(jnp.mean(outputs["epistemic_std_map"])) > 0

    def test_input_repetition_and_batch_repetitions(self, rng):
        task = tiny_task(input_repetition_probability=0.5, batch_repetitions=2)
        tx = task.make_optimizer(10)
        state = task.init_state(10)
        batch = synthetic_batch(rng, b=4)
        state, logs, outputs = task.train_step(
            tx, state, batch, jax.random.key(0), with_outputs=True
        )
        # B*reps*S flattened
        assert outputs["preds"].shape[0] == 4 * 2 * 2


class TestEvidentialTrainStep:
    def test_loss_decreases_and_positivity(self, rng):
        task = EvidentialUnetTask(in_channels=3, filter_base_count=4, seed=0)
        tx = task.make_optimizer(10)
        state = task.init_state(10)
        batch = synthetic_batch(rng)
        import functools

        step = jax.jit(functools.partial(task.train_step, tx, with_outputs=False))
        first = None
        for _ in range(30):
            state, logs, _ = step(state, batch, jax.random.key(0))
            if first is None:
                first = float(logs["train_loss"])
        assert float(logs["train_loss"]) < first

        out, _ = task.forward(
            state.params, state.model_state, batch["image"], train=False
        )
        v, alpha, beta = out[..., 1], out[..., 2], out[..., 3]
        assert float(jnp.min(v)) > 0
        assert float(jnp.min(alpha)) > 1
        assert float(jnp.min(beta)) > 0

    def test_val_step(self, rng):
        task = EvidentialUnetTask(in_channels=3, filter_base_count=4)
        state = task.init_state(10)
        logs, outputs = task.val_step(
            state.params, state.model_state, synthetic_batch(rng)
        )
        assert "val_loss" in logs and "metric_val/r2" in logs
        assert outputs["aleatoric_std_map"].shape == (8, 32, 32, 1)


class TestDeterminism:
    def test_same_seed_same_trajectory(self, rng):
        batch = synthetic_batch(rng)

        def run(seed):
            task = tiny_task(seed=seed, center_dropout_rate=0.1,
                             final_dropout_rate=0.1)
            tx = task.make_optimizer(10)
            state = task.init_state(10)
            losses = []
            for _ in range(3):
                state, logs, _ = task.train_step(
                    tx, state, batch, jax.random.key(seed)
                )
                losses.append(float(logs["train_loss"]))
            return losses

        a, b, c = run(0), run(0), run(1)
        np.testing.assert_array_equal(a, b)  # bitwise reproducible
        assert a != c  # different seed diverges

    def test_input_transform_keyed(self, rng):
        """Same key -> same shuffle; step-folded keys differ across steps."""
        task = tiny_task(batch_repetitions=2)
        tx = task.make_optimizer(10)
        state = task.init_state(10)
        batch = synthetic_batch(rng)
        s1, l1, _ = task.train_step(tx, state, batch, jax.random.key(5))
        s2, l2, _ = task.train_step(tx, state, batch, jax.random.key(5))
        np.testing.assert_array_equal(
            float(l1["train_loss"]), float(l2["train_loss"])
        )
        # the next step folds in state.step -> different transform
        s3, l3, _ = task.train_step(tx, s1, batch, jax.random.key(5))
        assert float(l3["train_loss"]) != float(l1["train_loss"])


class TestCheckpoint:
    def test_roundtrip_and_task_rebuild(self, rng, tmp_path):
        task = tiny_task(loss_buffer_size=3, filter_base_count=5)
        tx = task.make_optimizer(10)
        state = task.init_state(10)
        batch = synthetic_batch(rng)
        state, _, _ = task.train_step(tx, state, batch, jax.random.key(0))

        path = os.path.join(tmp_path, "ckpt")
        save_checkpoint(path, state, task.hparams())
        task2, state2 = load_checkpoint(path, steps_per_epoch=10)

        assert task2 == task
        assert int(state2.step) == 1
        for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(state2)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

        # the restored state continues training identically
        s_a, logs_a, _ = task.train_step(tx, state, batch, jax.random.key(1))
        s_b, logs_b, _ = task2.train_step(
            task2.make_optimizer(10), state2, batch, jax.random.key(1)
        )
        np.testing.assert_allclose(
            float(logs_a["train_loss"]), float(logs_b["train_loss"]), rtol=1e-6
        )


    @pytest.mark.parametrize("kind", ["mimo", "evidential"])
    def test_hparams_with_removed_fields_load(self, tmp_path, kind):
        """An hparams.json written before an option was removed (here the
        removed kernel-layer switch, tests/data/) still loads: unknown keys
        are dropped, the state restores."""
        import json
        import shutil

        from mimo_unet_tpu.train.checkpoint import _task_from_hparams

        old = os.path.join(os.path.dirname(__file__), "data",
                           f"old_hparams_{kind}.json")
        with open(old) as f:
            task = _task_from_hparams(json.load(f))
        state = task.init_state(10)
        path = os.path.join(tmp_path, "old")
        save_checkpoint(path, state, task.hparams())
        shutil.copy(old, os.path.join(path, "hparams.json"))
        task2, state2 = load_checkpoint(path, steps_per_epoch=10)
        assert task2 == task and task2.filter_base_count == 4
        for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(state2)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_async_manager_roundtrip(self, rng, tmp_path):
        """Back-to-back async dispatches (last while a previous last may
        still be in flight, then best) land durably and restore equal."""
        from mimo_unet_tpu.train.checkpoint import CheckpointManager

        task = tiny_task(loss_buffer_size=3, filter_base_count=5)
        tx = task.make_optimizer(10)
        state = task.init_state(10)
        state, _, _ = task.train_step(
            tx, state, synthetic_batch(rng), jax.random.key(0))

        mgr = CheckpointManager(str(tmp_path), task.hparams(),
                                async_save=True)
        mgr.save_last(state)
        mgr.save_last(state)
        assert mgr.maybe_save_best(state, 0.5, epoch=0, step=1)
        mgr.wait_until_finished()

        task2, state2 = load_checkpoint(mgr.last_path, steps_per_epoch=10)
        assert task2 == task
        for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(state2)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        _, state3 = load_checkpoint(mgr.best_path, steps_per_epoch=10)
        for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(state3)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestTrainerEndToEnd:
    def test_fit_on_synthetic_h5(self, tmp_path):
        from make_fixtures import make_nyuv2_h5
        from mimo_unet_tpu.data.nyuv2 import NYUv2DepthDataModule
        from mimo_unet_tpu.train.trainer import Trainer

        data_dir = make_nyuv2_h5(os.path.join(tmp_path, "data"), n=16, h=32, w=32)
        dm = NYUv2DepthDataModule(dataset_dir=data_dir, batch_size=8, seed=0)
        task = tiny_task()
        trainer = Trainer(
            task,
            dm,
            max_epochs=2,
            checkpoint_path=os.path.join(tmp_path, "ckpt"),
            log_every_n_steps=1,
            log_images=True,
            seed=0,
        )
        state = trainer.fit()
        assert int(state.step) == 4  # 2 epochs x (16 // 8) steps
        assert trainer.ckpt.has_last()
        assert os.path.isdir(trainer.ckpt.best_path)
        assert len(trainer.history) == 2
        # images were written by the OutputMonitor-equivalent
        img_dir = os.path.join(tmp_path, "ckpt", "images")
        assert os.path.isdir(img_dir) and len(os.listdir(img_dir)) > 0

        # resume continues from the checkpoint
        trainer2 = Trainer(
            task,
            dm,
            max_epochs=3,
            checkpoint_path=os.path.join(tmp_path, "ckpt"),
            log_every_n_steps=0,
            log_images=False,
            seed=0,
        )
        state2 = trainer2.fit(resume=True)
        assert int(state2.step) == 6

    def test_fit_with_masked_dataset(self, tmp_path):
        """Masks flow through prefetch -> train/val steps -> image monitor
        (the Make3D/MUAD-style batch contract)."""
        import jax.numpy as jnp
        from mimo_unet_tpu.data.core import ArrayDataset, DataModule
        from mimo_unet_tpu.train.trainer import Trainer

        rng = np.random.default_rng(0)
        image = rng.uniform(size=(8, 32, 32, 3)).astype(np.float32)
        label = image.mean(-1, keepdims=True).astype(np.float32)
        mask = (rng.uniform(size=(8, 32, 32, 1)) > 0.3).astype(np.float32)
        ds = ArrayDataset({"image": image, "label": label, "mask": mask})

        class DM(DataModule):
            batch_size = 4

            def setup(self):
                pass

            def train_dataset(self):
                return ds

            def val_dataset(self):
                return ds

        trainer = Trainer(
            tiny_task(), DM(), max_epochs=1,
            checkpoint_path=os.path.join(tmp_path, "ckpt"),
            log_every_n_steps=1, log_images=True, num_devices=4, seed=0,
        )
        state = trainer.fit()
        assert int(state.step) == 2
        assert np.isfinite(trainer.history[0]["val_loss"])

    def test_fit_device_cache_matches_host_feeding(self, tmp_path):
        """--device_cache (HBM-pinned dataset + on-chip gather) is a pure
        input-staging change: with the same seed it must reproduce the
        host-fed trajectory exactly (same index order via
        iterate_index_batches, same normalize inside the step)."""
        from make_fixtures import make_nyuv2_h5
        from mimo_unet_tpu.data.nyuv2 import NYUv2DepthDataModule
        from mimo_unet_tpu.train.trainer import Trainer

        data_dir = make_nyuv2_h5(os.path.join(tmp_path, "data"), n=16, h=32, w=32)
        states = []
        for cache in (False, True):
            dm = NYUv2DepthDataModule(
                dataset_dir=data_dir, batch_size=8, seed=0,
                host_dtype="uint8")
            trainer = Trainer(
                tiny_task(), dm, max_epochs=2,
                checkpoint_path=os.path.join(tmp_path, f"ckpt{cache}"),
                log_every_n_steps=0, log_images=False, num_devices=1,
                seed=0, device_cache=cache,
            )
            states.append(trainer.fit())
        assert int(states[0].step) == int(states[1].step) == 4
        for a, b in zip(jax.tree.leaves(states[0].params),
                        jax.tree.leaves(states[1].params)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_sharded_device_cache_gather_matches_rows(self):
        """Mesh-sharded DeviceDataset: per-device shard pinning with
        shard-local gather must return exactly the pinned-partition rows
        (the partition is randomized once at construction, then fixed)."""
        from mimo_unet_tpu.data.core import ArrayDataset, DeviceDataset
        from mimo_unet_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(4)
        n = 10  # not divisible by 4: wrapped pad (n_local=3, rows wrap)
        data = {"image": np.arange(n * 6, dtype=np.float32).reshape(n, 6)}
        ds = ArrayDataset(data)
        dev = DeviceDataset(ds, mesh=mesh)
        assert dev.n_shards == 4 and dev.n_local == 3
        wrapped = dev.wrapped
        # every row present; exactly n_local*d - n wrap duplicates
        assert sorted(set(wrapped.tolist())) == list(range(n))
        assert len(wrapped) == 12

        idx = np.array([[0, 2], [1, 0], [2, 1], [0, 2]], dtype=np.int32)
        got = jax.jit(dev.gather)(idx)["image"]
        want = np.concatenate([
            data["image"][wrapped[d * 3:(d + 1) * 3][idx[d]]]
            for d in range(4)
        ])
        np.testing.assert_array_equal(np.asarray(got), want)

        # explicit-operand form (jitted callers pass data through their
        # signature instead of capturing it)
        got2 = jax.jit(dev.gather)(idx, dev.data)["image"]
        np.testing.assert_array_equal(np.asarray(got2), want)

    def test_partial_device_cache_epoch_is_permutation(self):
        """PartialDeviceDataset: pin-what-fits capacity fallback.  Every row must be visited exactly once per epoch,
        cached batches must be full-size on-chip gathers, and the cached
        subset must respect the byte budget."""
        from mimo_unet_tpu.data.core import ArrayDataset, PartialDeviceDataset

        n, b = 37, 8
        data = {"image": np.arange(n * 4, dtype=np.float32).reshape(n, 4)}
        pds = PartialDeviceDataset(ArrayDataset(data), max_bytes=20 * 16,
                                   seed=3)
        assert pds.n_cached == 20 and len(pds.host_rows) == 17
        assert pds.nbytes <= 20 * 16

        seen = []
        n_cached_batches = 0
        for kind, item in pds.epoch_batches(b, seed=1, epoch=2):
            if kind == "cached":
                n_cached_batches += 1
                assert len(item) == b  # always full batches
                rows = pds.cached_rows[item]
                got = np.asarray(jax.jit(pds.cached.gather)(item)["image"])
                np.testing.assert_array_equal(got, data["image"][rows])
                seen.extend(rows.tolist())
            else:
                assert len(item["image"]) <= b
                seen.extend(int(v[0] / 4) for v in item["image"])
        assert sorted(seen) == list(range(n))  # exact epoch permutation
        assert n_cached_batches == 20 // b

        # drop_last=True: only the host stream's ragged tail is dropped
        total = sum(
            b if kind == "cached" else len(item["image"])
            for kind, item in pds.epoch_batches(b, seed=1, epoch=2,
                                                drop_last=True))
        assert total == (n // b) * b

    def test_fit_partial_device_cache(self, tmp_path):
        """Trainer capacity gate: a budget smaller than the split pins a
        subset and streams the rest; training runs end-to-end and sees
        the whole dataset (steps per epoch match drop_last=True)."""
        from make_fixtures import make_nyuv2_h5
        from mimo_unet_tpu.data.nyuv2 import NYUv2DepthDataModule
        from mimo_unet_tpu.train.trainer import Trainer

        data_dir = make_nyuv2_h5(os.path.join(tmp_path, "data"), n=16,
                                 h=32, w=32)
        dm = NYUv2DepthDataModule(dataset_dir=data_dir, batch_size=4,
                                  seed=0, host_dtype="uint8")
        dm.setup()
        from mimo_unet_tpu.data.core import dataset_nbytes

        budget = dataset_nbytes(dm.train_dataset()) // 2
        trainer = Trainer(
            tiny_task(), dm, max_epochs=2,
            checkpoint_path=os.path.join(tmp_path, "ckpt"),
            log_every_n_steps=0, log_images=False, num_devices=1, seed=0,
            device_cache=True, device_cache_budget=budget,
        )
        state = trainer.fit()
        assert int(state.step) == 2 * (16 // 4)
        assert all(np.all(np.isfinite(np.asarray(x)))
                   for x in jax.tree.leaves(state.params))

    def test_fit_device_cache_budget_gate_mesh_falls_back(self, tmp_path):
        """On a >1-device mesh a split over budget must fall back to host
        feeding (partial caching is single-device), not OOM."""
        from make_fixtures import make_nyuv2_h5
        from mimo_unet_tpu.data.nyuv2 import NYUv2DepthDataModule
        from mimo_unet_tpu.train.trainer import Trainer

        data_dir = make_nyuv2_h5(os.path.join(tmp_path, "data"), n=16,
                                 h=32, w=32)
        dm = NYUv2DepthDataModule(dataset_dir=data_dir, batch_size=8, seed=0)
        trainer = Trainer(
            tiny_task(), dm, max_epochs=1,
            checkpoint_path=os.path.join(tmp_path, "ckpt"),
            log_every_n_steps=0, log_images=False, num_devices=4, seed=0,
            device_cache=True, device_cache_budget=1024,
        )
        state = trainer.fit()
        assert int(state.step) == 2
        assert np.isfinite(trainer.history[-1]["val_loss"])

    def test_fit_sharded_device_cache_over_mesh(self, tmp_path):
        """--device_cache on a 4-device mesh: per-device shard pinning +
        shard-local sampling trains end-to-end (the pre-round-4 behavior
        was a fallback to host feeding)."""
        from make_fixtures import make_nyuv2_h5
        from mimo_unet_tpu.data.nyuv2 import NYUv2DepthDataModule
        from mimo_unet_tpu.train.trainer import Trainer

        data_dir = make_nyuv2_h5(os.path.join(tmp_path, "data"), n=8, h=32, w=32)
        dm = NYUv2DepthDataModule(dataset_dir=data_dir, batch_size=8, seed=0)
        trainer = Trainer(
            tiny_task(), dm, max_epochs=2,
            checkpoint_path=os.path.join(tmp_path, "ckpt"),
            log_every_n_steps=0, log_images=False, num_devices=4, seed=0,
            device_cache=True,
        )
        state = trainer.fit()
        assert int(state.step) == 2
        assert all(np.all(np.isfinite(np.asarray(x)))
                   for x in jax.tree.leaves(state.params))
        assert trainer.history and np.isfinite(
            trainer.history[-1]["val_loss"])

    def test_fit_sharded_over_mesh(self, tmp_path):
        """Data-parallel fit over all 8 virtual CPU devices."""
        from make_fixtures import make_nyuv2_h5
        from mimo_unet_tpu.data.nyuv2 import NYUv2DepthDataModule
        from mimo_unet_tpu.train.trainer import Trainer

        assert jax.device_count() >= 8
        data_dir = make_nyuv2_h5(os.path.join(tmp_path, "data"), n=16, h=32, w=32)
        dm = NYUv2DepthDataModule(dataset_dir=data_dir, batch_size=8, seed=0)
        task = tiny_task()
        trainer = Trainer(
            task,
            dm,
            max_epochs=1,
            checkpoint_path=os.path.join(tmp_path, "ckpt"),
            log_every_n_steps=0,
            log_images=False,
            num_devices=8,
            seed=0,
        )
        state = trainer.fit()
        assert int(state.step) == 2
        assert np.isfinite(trainer.history[0]["val_loss"])


class TestValPaddingInvariance:
    """Pad rows (added so the batch divides the mesh) must not contaminate
    validation means — Lightning weights self.log by true batch size
    (reference mimo/models/mimo_unet.py:283-291), so padding must be a no-op."""

    def test_val_step_valid_mask_mimo(self, rng):
        task = tiny_task()
        state = task.init_state(10)
        batch = synthetic_batch(rng, b=5)
        logs_ref, _ = task.val_step(state.params, state.model_state, batch)

        padded = {
            k: jnp.concatenate([v, jnp.repeat(v[-1:], 3, axis=0)], axis=0)
            for k, v in batch.items()
        }
        padded["valid"] = jnp.asarray([1, 1, 1, 1, 1, 0, 0, 0], jnp.float32)
        logs_pad, _ = task.val_step(state.params, state.model_state, padded)
        for k in logs_ref:
            np.testing.assert_allclose(
                float(logs_pad[k]), float(logs_ref[k]), rtol=2e-5, err_msg=k
            )
        # sanity: without the valid mask the pad rows DO shift the stats
        del padded["valid"]
        logs_dirty, _ = task.val_step(state.params, state.model_state, padded)
        assert abs(float(logs_dirty["metric_val/r2"]) - float(logs_ref["metric_val/r2"])) > 1e-7

    def test_val_step_valid_mask_evidential(self, rng):
        task = EvidentialUnetTask(in_channels=3, filter_base_count=4, seed=0)
        state = task.init_state(10)
        batch = synthetic_batch(rng, b=5)
        logs_ref, _ = task.val_step(state.params, state.model_state, batch)
        padded = {
            k: jnp.concatenate([v, jnp.repeat(v[-1:], 3, axis=0)], axis=0)
            for k, v in batch.items()
        }
        padded["valid"] = jnp.asarray([1, 1, 1, 1, 1, 0, 0, 0], jnp.float32)
        logs_pad, _ = task.val_step(state.params, state.model_state, padded)
        for k in logs_ref:
            np.testing.assert_allclose(
                float(logs_pad[k]), float(logs_ref[k]), rtol=2e-5, err_msg=k
            )

    def test_trainer_validate_pad_invariant(self, tmp_path, rng):
        """Epoch val metrics identical whether or not the final batch needs
        mesh padding (ndev=2 pads the odd tail batch; ndev=1 doesn't)."""
        from mimo_unet_tpu.data.core import ArrayDataset, DataModule
        from mimo_unet_tpu.train.trainer import Trainer

        image = rng.uniform(size=(5, 32, 32, 3)).astype(np.float32)
        label = image.mean(-1, keepdims=True).astype(np.float32)
        ds = ArrayDataset({"image": image, "label": label})

        class DM(DataModule):
            batch_size = 4

            def setup(self):
                pass

            def train_dataset(self):
                return ds

            def val_dataset(self):
                return ds

        task = tiny_task()
        state = task.init_state(1)

        def epoch_metrics(n_dev):
            trainer = Trainer(
                task, DM(), max_epochs=1,
                checkpoint_path=os.path.join(tmp_path, f"ckpt{n_dev}"),
                log_images=False, num_devices=n_dev, seed=0,
            )
            val_step = jax.jit(task.val_step)
            return trainer.validate(state, val_step, n_dev)

        a, b = epoch_metrics(1), epoch_metrics(2)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=2e-5, err_msg=k)


class TestResumeSemantics:
    def test_best_tracking_restored_on_resume(self, tmp_path, rng):
        from mimo_unet_tpu.train.checkpoint import CheckpointManager, load_hparams

        task = tiny_task()
        state = task.init_state(1)

        mgr = CheckpointManager(str(tmp_path), task.hparams())
        assert mgr.maybe_save_best(state, 0.5, epoch=0, step=1)
        assert not mgr.maybe_save_best(state, 0.7, epoch=1, step=2)
        # hparams publish only after the state commit (state-commit-first
        # ordering, ADVICE r4): a reader must wait_until_finished first —
        # which is what a real resume does (fit() waits before returning)
        mgr.wait_until_finished()

        # a resumed manager must pick up 0.5, not reset to inf
        mgr2 = CheckpointManager(str(tmp_path), task.hparams())
        assert mgr2.best_val_loss == float("inf")  # fresh by default
        assert mgr2.restore_best_tracking() == 0.5
        assert not mgr2.maybe_save_best(state, 0.7, epoch=2, step=3)
        assert load_hparams(mgr2.best_path)["best"]["val_loss"] == 0.5
        assert mgr2.maybe_save_best(state, 0.3, epoch=3, step=4)
        mgr2.wait_until_finished()
        assert load_hparams(mgr2.best_path)["best"]["val_loss"] == 0.3

    def test_fit_resume_equivalence(self, tmp_path):
        """fit(2 epochs) == fit(1) + resume(1): identical params, and best/
        never regresses across the resume boundary."""
        from make_fixtures import make_nyuv2_h5
        from mimo_unet_tpu.data.nyuv2 import NYUv2DepthDataModule
        from mimo_unet_tpu.train.trainer import Trainer

        data_dir = make_nyuv2_h5(os.path.join(tmp_path, "data"), n=8, h=32, w=32)

        def make(dirname, max_epochs):
            dm = NYUv2DepthDataModule(dataset_dir=data_dir, batch_size=4, seed=0)
            return Trainer(
                tiny_task(), dm, max_epochs=max_epochs,
                checkpoint_path=os.path.join(tmp_path, dirname),
                log_every_n_steps=0, log_images=False, num_devices=4, seed=0,
            )

        state_full = make("full", 2).fit()

        make("split", 1).fit()
        t_resume = make("split", 2)
        state_split = t_resume.fit(resume=True)

        assert int(state_full.step) == int(state_split.step) == 4
        for a, b in zip(
            jax.tree.leaves(state_full.params), jax.tree.leaves(state_split.params)
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        # the resumed manager saw epoch 0's best val_loss
        assert np.isfinite(t_resume.ckpt.best_val_loss)
