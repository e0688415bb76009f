"""Training harness: the Lightning-Trainer role.

One jitted train step (with buffer donation) over a data-parallel mesh;
background host->device prefetch; scalar logging on a cadence that never
blocks the device; image-grid monitoring (the reference's OutputMonitor
callback); save_last + best-by-val_loss checkpointing with resume.

Equivalent reference surface: pl.Trainer(...).fit(model, dm) as configured
in scripts/train/train_nyuv2_depth.py:70-82 (max_epochs, log_every_n_steps,
16-mixed AMP -> compute_dtype="bfloat16", ModelCheckpoint callbacks).
"""

from __future__ import annotations

import time
from functools import partial
from typing import Optional

import numpy as np
import jax

from mimo_unet_tpu.data.core import DataModule, prefetch_to_device
from mimo_unet_tpu.parallel.mesh import (
    batch_sharding,
    make_mesh,
    pad_batch_to_divisible,
    replicated_sharding,
)
from mimo_unet_tpu.train.checkpoint import CheckpointManager
from mimo_unet_tpu.train.logging import MetricLogger, TSVLogger
from mimo_unet_tpu.visualization import output_monitor_images


class Trainer:
    def __init__(
        self,
        task,
        datamodule: DataModule,
        *,
        max_epochs: int,
        checkpoint_path: str,
        logger: Optional[MetricLogger] = None,
        log_every_n_steps: int = 200,
        monitor_mode: str = "depth",
        monitor_targets=None,
        log_images: bool = True,
        mesh=None,
        num_devices: Optional[int] = None,
        seed: int = 42,
        device_cache: bool = False,
        device_cache_budget: Optional[int] = None,
        host_chunk: int = 1,
    ):
        self.task = task
        self.dm = datamodule
        self.max_epochs = max_epochs
        self.log_every_n_steps = log_every_n_steps
        self.monitor_mode = monitor_mode
        self.monitor_targets = monitor_targets
        self.log_images = log_images
        self.seed = seed
        self.device_cache = device_cache
        # bytes of HBM the cache may take; None = auto from PJRT
        # memory_stats (data/core.py device_cache_budget_bytes)
        self.device_cache_budget = device_cache_budget
        self.host_chunk = host_chunk
        self.mesh = mesh if mesh is not None else make_mesh(num_devices)
        self.logger = logger if logger is not None else TSVLogger(checkpoint_path)
        self.ckpt = CheckpointManager(checkpoint_path, task.hparams())
        self.history: list = []
        self._timing_warm = False  # first step of the process pays compile

    # ------------------------------------------------------------------ fit

    def fit(self, resume: bool = False):
        task, dm = self.task, self.dm
        dm.setup()
        n_train = len(dm.train_dataset())
        steps_per_epoch = max(n_train // dm.batch_size, 1)
        tx = task.make_optimizer(steps_per_epoch)

        if dm.batch_size % self.mesh.size != 0:
            raise ValueError(
                f"batch_size={dm.batch_size} must be divisible by the mesh "
                f"size ({self.mesh.size} devices); pass num_devices to shrink "
                f"the mesh or adjust --batch_size"
            )

        if resume and self.ckpt.has_last():
            from mimo_unet_tpu.train.checkpoint import load_checkpoint

            _, state = load_checkpoint(self.ckpt.last_path, steps_per_epoch)
            start_epoch = int(state.step) // steps_per_epoch
            # restore best-val tracking so a post-resume epoch with a worse
            # val_loss never overwrites best/ (the reference's ModelCheckpoint
            # keeps this in its own state, train_nyuv2_depth.py:22-36)
            self.ckpt.restore_best_tracking()
            print(f"[trainer] resumed from step {int(state.step)} (epoch {start_epoch})")
        else:
            state = task.init_state(steps_per_epoch)
            start_epoch = 0

        repl = replicated_sharding(self.mesh)
        data_shard = batch_sharding(self.mesh)
        state = jax.device_put(state, repl)
        rng = jax.device_put(jax.random.key(self.seed), repl)

        train_step = jax.jit(
            partial(task.train_step, tx, with_outputs=False),
            donate_argnums=(0,),
            in_shardings=(repl, data_shard, repl),
            out_shardings=(repl, repl, None),
        )
        train_step_with_outputs = jax.jit(
            partial(task.train_step, tx, with_outputs=True),
            in_shardings=(repl, data_shard, repl),
        )

        # ------------- device-resident dataset (extension) -------------
        # Pin the train split in device HBM once and fold the batch gather
        # into the jitted step: per-step host work becomes drawing indices.
        # Multi-device meshes pin per-device row shards and sample
        # shard-locally (DistributedSampler semantics — data/core.py
        # DeviceDataset).
        use_cache = self.device_cache
        partial_ds = None
        if use_cache:
            from mimo_unet_tpu.data.core import (
                DeviceDataset, PartialDeviceDataset, dataset_nbytes,
                device_cache_budget_bytes)

            # ---- capacity gate: a split that does not fit HBM must not
            # silently lose (or OOM) the fast path.  Budget = explicit
            # bytes, else 60% of the backend's free HBM (None on backends
            # without a limit, e.g. CPU tests -> no gate).
            need = dataset_nbytes(dm.train_dataset())
            budget = self.device_cache_budget
            if budget is None:
                budget = device_cache_budget_bytes()
            per_dev = need // max(self.mesh.size, 1)
            if budget is not None and per_dev > budget:
                if self.mesh.size > 1:
                    # partial caching is single-device only (per-device
                    # row shards are pinned wholesale); fall back to the
                    # host-fed path rather than OOM HBM
                    print(f"[trainer] device cache disabled: split needs "
                          f"{per_dev / 1e6:.0f} MB/device > "
                          f"{budget / 1e6:.0f} MB budget (host-fed "
                          f"fallback; use more devices or --host_chunk)")
                    use_cache = False
                else:
                    partial_ds = PartialDeviceDataset(
                        dm.train_dataset(), budget, seed=self.seed)
                    dev_ds = partial_ds.cached
                    print(f"[trainer] device cache (partial): "
                          f"{partial_ds.n_cached}/{len(partial_ds)} rows "
                          f"pinned ({dev_ds.nbytes / 1e6:.0f} of "
                          f"{need / 1e6:.0f} MB; remainder streamed)")
            if use_cache and partial_ds is None:
                dev_ds = DeviceDataset(
                    dm.train_dataset(),
                    mesh=self.mesh if self.mesh.size > 1 else None,
                    seed=self.seed)
                shards = (f" x {dev_ds.n_shards} shards"
                          if dev_ds.n_shards > 1 else "")
                print(f"[trainer] device cache: {len(dev_ds)} items, "
                      f"{dev_ds.nbytes / 1e6:.0f} MB in HBM{shards}")
        if use_cache:

            def _cached_step(with_outputs, state, data, idx, rng):
                # data flows through the jitted signature (not closure) so
                # the step's input dependence is explicit on both branches
                batch = dev_ds.gather(idx, data)
                return task.train_step(
                    tx, state, batch, rng, with_outputs=with_outputs)

            idx_shard = dev_ds.index_sharding()
            cached_step = jax.jit(
                partial(_cached_step, False), donate_argnums=(0,),
                in_shardings=(repl, None, idx_shard, repl))
            cached_step_with_outputs = jax.jit(
                partial(_cached_step, True),
                in_shardings=(repl, None, idx_shard, repl))
        val_step = jax.jit(
            task.val_step, in_shardings=(repl, repl, data_shard)
        )

        n_dev = self.mesh.size
        global_step = int(state.step)
        for epoch in range(start_epoch, self.max_epochs):
            # ---------------- train ----------------
            t_epoch = time.time()
            images_seen = 0
            pending_logs = None
            if partial_ds is not None:
                # partial cache: full-size on-chip-gather batches for the
                # pinned rows, uploaded batches for the streamed remainder
                batches = partial_ds.epoch_batches(
                    dm.batch_size, seed=self.seed, epoch=epoch,
                    shuffle=True, drop_last=True,
                )
            elif use_cache and dev_ds.mesh is not None:
                from mimo_unet_tpu.data.core import (
                    iterate_sharded_index_batches)

                batches = iterate_sharded_index_batches(
                    len(dev_ds), dev_ds.n_shards, dm.batch_size,
                    shuffle=True, seed=self.seed, epoch=epoch,
                )
            elif use_cache:
                from mimo_unet_tpu.data.core import iterate_index_batches

                batches = iterate_index_batches(
                    len(dev_ds), dm.batch_size,
                    shuffle=True, drop_last=True,
                    seed=self.seed, epoch=epoch,
                )
            else:
                # host-fed path; chunk>1 uploads `chunk` batches with one
                # device_put and slices them on device (data/core.py
                # prefetch_to_device)
                batches = prefetch_to_device(
                    dm.train_batches(epoch, seed=self.seed),
                    sharding=data_shard,
                    chunk=self.host_chunk,
                )
            for batch in batches:
                on_chip = use_cache
                if partial_ds is not None:
                    kind, batch = batch
                    if kind == "host":
                        on_chip = False
                        batch = {
                            k: jax.device_put(v, data_shard)
                            for k, v in batch.items() if v is not None
                        }
                want_images = (
                    self.log_images
                    and self.log_every_n_steps > 0
                    and global_step % self.log_every_n_steps == 0
                )
                if on_chip:
                    n_batch = int(np.asarray(batch).size
                                  if batch.ndim > 1 else len(batch))
                    if want_images:
                        new_state, logs, outputs = cached_step_with_outputs(
                            state, dev_ds.data, batch, rng
                        )
                        self._log_images(global_step, outputs, stage="train")
                        state = new_state
                    else:
                        state, logs, _ = cached_step(
                            state, dev_ds.data, batch, rng
                        )
                elif want_images:
                    n_batch = len(next(iter(batch.values())))
                    new_state, logs, outputs = train_step_with_outputs(
                        state, batch, rng
                    )
                    self._log_images(global_step, outputs, stage="train")
                    state = new_state
                else:
                    n_batch = len(next(iter(batch.values())))
                    state, logs, _ = train_step(state, batch, rng)
                images_seen += n_batch
                if not self._timing_warm:
                    # the first step of the process includes XLA compilation;
                    # restart the epoch clock so throughput reflects steady
                    # state (the compile still happened, just isn't averaged
                    # into throughput_images_per_sec)
                    jax.block_until_ready(logs)
                    self._timing_warm = True
                    t_epoch = time.time()
                    images_seen = 0
                if self.log_every_n_steps > 0 and global_step % self.log_every_n_steps == 0:
                    # fetch the *previous* pending logs so we never sync on
                    # the step we just dispatched
                    if pending_logs is not None:
                        self._flush_scalars(*pending_logs)
                    pending_logs = (global_step, logs)
                global_step += 1
            if pending_logs is not None:
                self._flush_scalars(*pending_logs)
                pending_logs = None

            dt = time.time() - t_epoch
            throughput = images_seen / dt if dt > 0 else 0.0

            # ---------------- validation ----------------
            val_logs = self.validate(state, val_step, n_dev)
            epoch_scalars = {
                "epoch": epoch,
                "throughput_images_per_sec": throughput,
                **val_logs,
            }
            self.logger.log_scalars(global_step, epoch_scalars)
            self.history.append(epoch_scalars)
            print(
                f"[epoch {epoch}] {throughput:.1f} img/s  "
                + "  ".join(
                    f"{k}={v:.5f}" for k, v in val_logs.items() if k == "val_loss"
                )
            )

            # ---------------- checkpoint ----------------
            self.ckpt.save_last(state)
            if "val_loss" in val_logs:
                self.ckpt.maybe_save_best(
                    state, val_logs["val_loss"], epoch, global_step
                )
        # async saves must be durable before fit() returns (resume and
        # checkpoint-archiving sinks read the directories right after)
        self.ckpt.wait_until_finished()
        # wandb log_model parity (reference train_nyuv2_depth.py:67-68):
        # sinks that archive checkpoints get the final one
        if hasattr(self.logger, "log_checkpoint"):
            self.logger.log_checkpoint(self.ckpt.last_path)
        return state

    # ------------------------------------------------------------ validation

    def validate(self, state, val_step, n_dev: int) -> dict:
        sums: dict = {}
        count = 0
        first_outputs = None
        for batch in self.dm.val_batches():
            batch = {k: v for k, v in batch.items() if v is not None}
            batch, real = pad_batch_to_divisible(batch, n_dev)
            b = len(next(iter(batch.values())))
            if real != b:
                # 0/1 row validity: pad rows must not enter any logged mean
                batch["valid"] = (np.arange(b) < real).astype(np.float32)
            logs, outputs = val_step(state.params, state.model_state, batch)
            if first_outputs is None:
                first_outputs = outputs
            w = real
            for k, v in logs.items():
                sums[k] = sums.get(k, 0.0) + float(v) * w
            count += w
        if count == 0:
            return {}
        if self.log_images and first_outputs is not None:
            self._log_images(int(state.step), first_outputs, stage="val")
        return {k: v / count for k, v in sums.items()}

    # ---------------------------------------------------------------- helpers

    def _flush_scalars(self, step: int, logs) -> None:
        self.logger.log_scalars(step, {k: float(v) for k, v in logs.items()})

    def _log_images(self, step: int, outputs: dict, stage: str) -> None:
        if not self.log_images:
            return
        try:
            host = {
                k: (np.asarray(v) if v is not None else None)
                for k, v in outputs.items()
            }
            images = output_monitor_images(
                host, self.monitor_mode, target_names=self.monitor_targets
            )
            for name, img in images.items():
                self.logger.log_image(step, f"{stage}/{name}", img)
        except Exception as e:
            print(f"[trainer] image logging failed: {e}")
