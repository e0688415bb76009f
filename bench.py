"""Benchmark: 256x256 patches/sec, NYUv2-depth MIMO M=2 train + infer.

Protocol mirrors the reference's measure_inference_speed.py (reference:
scripts/test/measure_inference_speed.py:25-47 — warm-up passes then timed
reps with device sync), scaled to accelerator batch sizes.

Prints one JSON line per metric ({"metric", "value", "unit", "device"}),
each the moment its section completes, so a later failure cannot erase
the earlier numbers.  A failed section makes the run exit nonzero.  The
headline inference line is printed again last with the train number
embedded, for consumers that read only the last line.
"""

import json
import sys
import time
import traceback


def _device_tag() -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _emit(payload):
    print(json.dumps({**payload, "device": _device_tag()}), flush=True)


def _section(name, failed: list):
    """Decorator: run a bench section; a failure is reported and appended
    to ``failed`` (the run then exits nonzero) without losing the other
    sections."""

    def deco(fn):
        def run(*args, **kwargs):
            try:
                return fn(*args, **kwargs)
            except Exception:
                print(f"[bench] section {name!r} FAILED:", file=sys.stderr)
                traceback.print_exc()
                failed.append(name)
                return None

        return run

    return deco


def main():
    import functools

    import jax
    import jax.numpy as jnp

    from mimo_unet_tpu.tasks import MimoUnetTask
    from mimo_unet_tpu.train.profiling import timed_per_exec
    from mimo_unet_tpu.transforms import compute_uncertainties, repeat_subnetworks
    from mimo_unet_tpu.utils import enable_compile_cache

    enable_compile_cache()
    if jax.devices()[0].platform == "cpu":
        sys.exit("[bench] no accelerator: CPU timings are not device metrics")
    failed = []

    task = MimoUnetTask(
        in_channels=3,
        out_channels=2,
        num_subnetworks=2,
        filter_base_count=21,
        loss="laplace_nll",
        seed=0,
        compute_dtype="bfloat16",
    )
    state = task.init_state(steps_per_epoch=1)
    loss_fn = task.loss_fn

    @jax.jit
    def infer(params, model_state, image):
        x = repeat_subnetworks(image, task.num_subnetworks)
        (p1, p2), _ = task.forward(params, model_state, x, train=False)
        mean, ale, epi = compute_uncertainties(loss_fn, p1, p2)
        # reduce to a scalar on device so materializing the result costs ~0
        return mean.mean() + ale.mean() + epi.mean()

    def timed_throughput(fn, args, batch_size: int, reps: int = 20) -> float:
        return batch_size / timed_per_exec(fn, *args, reps=reps)

    # ----------------------------------------------------------- inference
    @_section("inference", failed)
    def bench_inference():
        best, best_bs = 0.0, 0
        for batch_size in (32, 64, 128):
            x = jax.random.uniform(
                jax.random.key(0), (batch_size, 256, 256, 3), jnp.float32
            )
            throughput = timed_throughput(
                infer, (state.params, state.model_state, x), batch_size
            )
            if throughput > best:
                best, best_bs = throughput, batch_size
        return best, best_bs

    infer_res = bench_inference()
    if infer_res:
        best, best_bs = infer_res
        _emit(
            {
                "metric": "nyuv2_mimo_m2_256px_inference_patches_per_sec",
                "value": round(best, 1),
                "unit": f"patches/sec (best batch={best_bs}, bf16)",
            }
        )

    # --------------------------------------------------------------- train
    # one full optimization step (fwd+bwd+Adam+loss buffer), the reference
    # training configuration: batch 64, laplace NLL (Readme.md:61-79)
    tx = task.make_optimizer(steps_per_epoch=1000)
    train_step = jax.jit(
        functools.partial(task.train_step, tx, with_outputs=False),
        donate_argnums=(0,),
    )

    @_section("train", failed)
    def bench_train():
        from mimo_unet_tpu.train.capacity import make_train_step

        train_best, train_best_bs = 0.0, 0
        # a batch too large for device memory with full residual saving
        # compiles via remat (the capacity ladder, train/capacity.py)
        # instead of a try/except dropping it from the sweep.
        for batch_size in (64, 128, 192):
            batch = {
                "image": jax.random.uniform(
                    jax.random.key(1), (batch_size, 256, 256, 3), jnp.float32
                ),
                "label": jax.random.uniform(
                    jax.random.key(2), (batch_size, 256, 256, 1), jnp.float32
                ),
            }
            rngk = jax.random.key(0)
            carry = {"s": jax.device_put(task.init_state(steps_per_epoch=1000))}
            step, task_used = make_train_step(
                task, tx, carry["s"], batch, rngk
            )

            def step_scalar(_unused):
                new_state, logs, _ = step(carry["s"], batch, rngk)
                carry["s"] = new_state
                return logs["train_loss"]

            rate = timed_throughput(step_scalar, (0,), batch_size)
            print(f"[bench] train B={batch_size} remat={task_used.remat}: "
                  f"{rate:.1f} img/s", file=sys.stderr)
            if rate > train_best:
                train_best, train_best_bs = rate, batch_size
        return train_best, train_best_bs

    train_res = bench_train()
    if train_res:
        train_best, train_best_bs = train_res
        _emit(
            {
                "metric": "nyuv2_mimo_m2_256px_train_patches_per_sec",
                "value": round(train_best, 1),
                "unit": f"patches/sec (fwd+bwd+opt, best batch={train_best_bs}, bf16)",
            }
        )

    # ------------------------------------------------ 640x480 frame train
    # Synthetic NYUv2-shaped frames (640x480 uint8, the real archives'
    # schema and dtype, made from a seed in host memory) -> host feeding
    # with background prefetch, or a one-time device cache -> jitted train
    # step, timed over whole epochs including every host-side cost.
    @_section("640x480 frame train", failed)
    def bench_frames():
        import numpy as np

        from mimo_unet_tpu.data.core import (
            ArrayDataset,
            DeviceDataset,
            iterate_batches,
            iterate_index_batches,
            prefetch_to_device,
        )

        n_frames, fh, fw = 192, 480, 640
        rng_np = np.random.default_rng(0)
        img = rng_np.integers(0, 255, (n_frames, fh, fw, 3), dtype=np.uint8)
        real_ds = ArrayDataset({
            "image": img,
            "label": img.mean(axis=-1, keepdims=True).astype(np.uint8),
        })

        real_bs = 16
        rngk = jax.random.key(0)

        def run_epoch(epoch, chunk=1):
            t0 = time.perf_counter()
            seen = 0
            logs = None
            batches = prefetch_to_device(
                iterate_batches(
                    real_ds, real_bs, shuffle=True, drop_last=True,
                    seed=0, epoch=epoch,
                ),
                chunk=chunk,
            )
            st = run_epoch.state
            for batch in batches:
                st, logs, _ = train_step(st, batch, rngk)
                seen += real_bs
            run_epoch.state = st
            float(logs["train_loss"])  # true end-to-end sync
            return seen / (time.perf_counter() - t0)

        run_epoch.state = jax.device_put(task.init_state(steps_per_epoch=1000))
        run_epoch(0)  # compile + warm
        host_fed_runs = [run_epoch(e) for e in (1, 2, 3)]
        host_fed_rate = max(host_fed_runs)
        # chunked uploads (--host_chunk): one device_put per `chunk` steps
        chunked_runs = [run_epoch(e, chunk=8) for e in (4, 5, 6)]
        host_chunk_rate = max(chunked_runs)

        # Device-resident dataset (--device_cache): the whole uint8 train
        # split is staged into device memory once; each step's batch gather
        # happens on device inside the jitted step, so per-step host work is
        # drawing indices.
        dev_ds = DeviceDataset(real_ds)

        def _cached_step(st, data, idx, rngk):
            batch = {k: jnp.take(v, idx, axis=0) for k, v in data.items()}
            return task.train_step(tx, st, batch, rngk, with_outputs=False)

        cached_step = jax.jit(_cached_step, donate_argnums=(0,))

        def run_epoch_cached(epoch):
            t0 = time.perf_counter()
            seen = 0
            logs = None
            st = run_epoch_cached.state
            for idx in iterate_index_batches(
                len(dev_ds), real_bs, shuffle=True, drop_last=True,
                seed=0, epoch=epoch,
            ):
                st, logs, _ = cached_step(st, dev_ds.data, idx, rngk)
                seen += real_bs
            run_epoch_cached.state = st
            float(logs["train_loss"])  # true end-to-end sync
            return seen / (time.perf_counter() - t0)

        run_epoch_cached.state = jax.device_put(
            task.init_state(steps_per_epoch=1000)
        )
        run_epoch_cached(0)  # compile + warm
        cached_rate = max(run_epoch_cached(e) for e in (1, 2, 3))
        patch_equiv = fh * fw / (256.0 * 256.0)
        _emit(
            {
                "metric": "nyuv2_mimo_m2_synthetic_640x480_train_img_per_sec",
                "value": round(cached_rate, 1),
                "unit": (
                    f"whole synthetic 640x480 frames/sec, one-time device "
                    f"staging->on-device gather (--device_cache)->train "
                    f"step, batch {real_bs}, bf16"
                ),
                "patch_equiv_per_sec": round(cached_rate * patch_equiv, 1),
                "host_fed_img_per_sec": round(host_fed_rate, 1),
                "host_fed_runs": [round(v, 1) for v in host_fed_runs],
                "host_chunk8_img_per_sec": round(host_chunk_rate, 1),
                "host_chunk8_runs": [round(v, 1) for v in chunked_runs],
            }
        )

    bench_frames()

    # re-emit the headline inference line LAST with the train number
    # embedded, so single-line consumers (the driver takes the last parsed
    # line) always see the headline even if a later section failed
    if infer_res:
        best, best_bs = infer_res
        payload = {
            "metric": "nyuv2_mimo_m2_256px_inference_patches_per_sec",
            "value": round(best, 1),
            "unit": f"patches/sec (best batch={best_bs}, bf16)",
        }
        if train_res:
            payload["train_patches_per_sec"] = round(train_res[0], 1)
            payload["train_batch"] = train_res[1]
        _emit(payload)
    if failed:
        sys.exit(f"[bench] failed sections: {failed}")


if __name__ == "__main__":
    main()
