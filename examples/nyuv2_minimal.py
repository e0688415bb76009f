"""Minimal raw-API training loop (the reference notebook's cell 14 contract).

The reference ships a Colab notebook (reference MIMO_U_Net_NYUv2_depth.ipynb)
whose final cell demonstrates the library API without Lightning: input
transform -> forward -> split p1/p2 -> per-subnetwork loss -> loss-buffer
weights -> weighted mean -> optimizer step.  This script is the same
minimal semantics against this framework's pure-functional API, runnable on
synthetic data (no downloads):

    python examples/nyuv2_minimal.py [--steps 50] [--dataset_dir DIR]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import jax
import jax.numpy as jnp

from mimo_unet_tpu.utils import enable_compile_cache


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--dataset_dir", type=str, default=None,
                        help="optional real NYUv2 dir with depth_train.h5")
    args = parser.parse_args()
    enable_compile_cache()

    from mimo_unet_tpu.data.core import iterate_batches
    from mimo_unet_tpu.tasks import MimoUnetTask

    # -- data: real h5 if given, synthetic otherwise --------------------------
    if args.dataset_dir:
        from mimo_unet_tpu.data.nyuv2 import load_nyuv2_depth

        ds = load_nyuv2_depth(os.path.join(args.dataset_dir, "depth_train.h5"))
    else:
        from mimo_unet_tpu.data.core import ArrayDataset

        rng = np.random.default_rng(0)
        image = rng.uniform(size=(64, 64, 64, 3)).astype(np.float32)
        ds = ArrayDataset(
            {"image": image, "label": image.mean(-1, keepdims=True)}
        )

    # -- model/task (notebook config: S=2, fbc=21, laplace, buffer 10) --------
    task = MimoUnetTask(
        in_channels=3, out_channels=2, num_subnetworks=2,
        filter_base_count=21, loss="laplace_nll",
        loss_buffer_size=10, loss_buffer_temperature=0.3,
        input_repetition_probability=0.0, batch_repetitions=2,
        learning_rate=1e-3, seed=42,
    )
    steps_per_epoch = max(len(ds) // args.batch_size, 1)
    tx = task.make_optimizer(steps_per_epoch)
    state = task.init_state(steps_per_epoch)
    print(f"trainable params: {task.trainable_params(state):,}")

    import functools

    train_step = jax.jit(functools.partial(task.train_step, tx, with_outputs=False))
    rng_key = jax.random.key(0)

    step = 0
    while step < args.steps:
        for batch in iterate_batches(ds, args.batch_size, shuffle=True,
                                     drop_last=True, seed=1, epoch=step):
            batch = {k: jnp.asarray(v) for k, v in batch.items()}
            state, logs, _ = train_step(state, batch, rng_key)
            if step % 10 == 0:
                print(
                    f"step {step:4d}  loss={float(logs['train_loss']):.4f}  "
                    + "  ".join(
                        f"w{i}={float(logs[f'train_weight_{i}']):.3f}"
                        for i in range(task.num_subnetworks)
                    )
                )
            step += 1
            if step >= args.steps:
                break

    # validation-style uncertainty decomposition on one batch
    batch = {k: jnp.asarray(v) for k, v in ds[np.arange(args.batch_size)].items()}
    logs, outputs = jax.jit(task.val_step)(state.params, state.model_state, batch)
    print(
        f"final: val_loss={float(logs['val_loss']):.4f} "
        f"r2={float(logs['metric_val/r2']):.4f} "
        f"aleatoric_std={float(logs['metric_val/aleatoric_std_mean']):.4f} "
        f"epistemic_std={float(logs['metric_val/epistemic_std_mean']):.4f}"
    )


if __name__ == "__main__":
    main()
