"""Measure ensemble inference latency.

Mirrors the reference protocol (reference scripts/test/
measure_inference_speed.py:22-47: 10 warm-up passes, 1000 timed reps with a
device sync, mean/std ms printed).
"""

import os
import sys
from argparse import ArgumentParser

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))


def main(args):
    import jax

    from mimo_unet_tpu.models.ensemble import Ensemble
    from mimo_unet_tpu.train.profiling import timed_per_exec
    from mimo_unet_tpu.utils import enable_compile_cache

    enable_compile_cache()

    model = Ensemble(
        checkpoint_paths=args.model_checkpoint_paths,
        monte_carlo_steps=args.monte_carlo_steps,
        return_raw_predictions=False,
    )

    @jax.jit
    def infer(x):
        mean, ale, epi = model(x)
        return mean.mean() + ale.mean() + epi.mean()

    dummy = jax.random.normal(
        jax.random.key(0), (1, args.height, args.width, args.in_channels)
    )
    # reference protocol: 10 warm-up passes, then every rep timed alone and
    # synced with the device before the next one
    timings = 1000.0 * np.asarray(timed_per_exec(
        infer, dummy, reps=args.repetitions, warmup=10, per_rep=True))
    print(f"mean: {timings.mean():.3f} ms, std: {timings.std():.3f} ms")


if __name__ == "__main__":
    parser = ArgumentParser()
    parser.add_argument("--model_checkpoint_paths", nargs="+", type=str, required=True)
    parser.add_argument("--monte_carlo_steps", type=int, default=0)
    # accepted for reference-CLI compatibility; JAX picks the device
    parser.add_argument("--device", type=str, default=None)
    parser.add_argument("--in_channels", type=int, required=True)
    parser.add_argument("--height", type=int, required=True)
    parser.add_argument("--width", type=int, required=True)
    parser.add_argument("--repetitions", type=int, default=1000)
    main(parser.parse_args())
