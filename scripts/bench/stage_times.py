"""Device time of the model's stages against the whole step, on one GPU.

    python scripts/bench/stage_times.py [--batch 64] [--size 256] [--reps 20]

Times, for the flagship configuration (S=2, filter_base_count 21,
laplace_nll, bf16), the whole inference forward and the whole train step,
and each stage as its own jitted function: the per-subnetwork encoder
(in_conv, down1), the shared core (down2..up3) and the per-subnetwork
decoder (up4, outc) — forward alone for inference, forward plus backward
(one VJP) for training.  Stages run as separate programs, so their sum
differs from the fused step by what XLA fuses across the boundaries.
Every timed window ends in ``block_until_ready``.
"""

import functools
import os
import subprocess
import sys
from argparse import ArgumentParser

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from mimo_unet_tpu.utils import enable_compile_cache


def main(args):
    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from mimo_unet_tpu.models.mimo_unet import (core_apply, decoder_apply,
                                                encoder_apply)
    from mimo_unet_tpu.tasks import MimoUnetTask
    from mimo_unet_tpu.train.profiling import timed_per_exec
    from mimo_unet_tpu.transforms import compute_uncertainties, repeat_subnetworks

    dev = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip() if dev.platform == "gpu" else "none"
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}; "
          f"nvidia-smi: {card}")

    task = MimoUnetTask(in_channels=3, out_channels=2, num_subnetworks=2,
                        filter_base_count=args.filter_base_count,
                        loss="laplace_nll", seed=0, compute_dtype="bfloat16")
    cfg = task.model_config
    state = task.init_state(steps_per_epoch=1000)
    tx = task.make_optimizer(steps_per_epoch=1000)
    p, st = state.params, state.model_state
    k = jax.random.split(jax.random.key(0), 4)
    image = jax.random.uniform(k[0], (args.batch, args.size, args.size, 3))
    batch = {"image": image,
             "label": jax.random.uniform(k[1], image.shape[:-1] + (1,))}
    x = repeat_subnetworks(image, cfg.num_subnetworks)
    rng = k[2]

    def t_ms(fn, *a):
        return 1e3 * timed_per_exec(jax.jit(fn), *a, reps=args.reps, warmup=2)

    def enc(train):
        return lambda p_, v: encoder_apply(p_, st["encoder"], v, cfg,
                                           train=train, rng=rng)[0]

    def core(train):
        return lambda p_, v: core_apply(p_, st["core"], v, cfg, train=train,
                                        rng=rng)[0]

    def dec(train):
        def f(p_, x_up, x1s):
            return decoder_apply(p_, st["decoder"], x_up, x1s, None, cfg,
                                 train=train, rng=rng)[0]
        return f

    def fwd_bwd(fn):
        """Forward + backward of one stage: VJP against ones."""
        def f(*a):
            out, vjp = jax.vjp(fn, *a)
            return vjp(jax.tree.map(jnp.ones_like, out))
        return f

    # stage inputs, computed once
    x1s, x2s, _ = jax.jit(enc(False))(p["encoder"], x)
    x2c = jnp.moveaxis(x2s, 0, -2).reshape(x2s.shape[1:-1] + (-1,))
    x_up = jax.jit(core(False))(p["core"], x2c)

    def infer(p_, s_, img):
        xx = repeat_subnetworks(img, cfg.num_subnetworks)
        (p1, p2), _ = task.forward(p_, s_, xx, train=False)
        return compute_uncertainties(task.loss_fn, p1, p2)

    step = jax.jit(functools.partial(task.train_step, tx), donate_argnums=(0,))
    carry = {"s": task.init_state(steps_per_epoch=1000)}  # donated

    def train_once():
        carry["s"], logs, _ = step(carry["s"], batch, rng)
        return logs["train_loss"]

    rows = [
        ("whole step", t_ms(infer, p, st, image),
         1e3 * timed_per_exec(train_once, reps=args.reps, warmup=2)),
        ("encoder (in_conv, down1)", t_ms(enc(False), p["encoder"], x),
         t_ms(fwd_bwd(enc(True)), p["encoder"], x)),
        ("core (down2..up3)", t_ms(core(False), p["core"], x2c),
         t_ms(fwd_bwd(core(True)), p["core"], x2c)),
        ("decoder (up4, outc)", t_ms(dec(False), p["decoder"], x_up, x1s),
         t_ms(fwd_bwd(dec(True)), p["decoder"], x_up, x1s)),
    ]
    whole_i, whole_t = rows[0][1], rows[0][2]
    print(f"B={args.batch} {args.size}x{args.size} bf16, "
          f"{args.reps} reps; stage ms and share of the whole step")
    print(f"{'stage':28s} {'infer ms':>10s} {'share':>7s} "
          f"{'train ms':>10s} {'share':>7s}")
    for name, ti, tt in rows:
        print(f"{name:28s} {ti:10.3f} {ti / whole_i:7.1%} "
              f"{tt:10.3f} {tt / whole_t:7.1%}")


if __name__ == "__main__":
    parser = ArgumentParser()
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--filter_base_count", type=int, default=21)
    parser.add_argument("--reps", type=int, default=20)
    main(parser.parse_args())
