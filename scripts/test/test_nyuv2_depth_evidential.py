"""Evaluate an evidential U-Net on NYUv2 depth with FGSM sweeps.

Mirrors reference scripts/test/test_nyuv2_depth_evidential.py:150-230:
single checkpoint, closed-form NIG aleatoric/epistemic uncertainties, same
artifact set per (dataset, epsilon in {0.00, 0.02, 0.04}).
"""

import os
import sys
from argparse import ArgumentParser
from pathlib import Path

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from mimo_unet_tpu.utils import enable_compile_cache
from mimo_unet_tpu.data.nyuv2 import load_nyuv2_depth
from mimo_unet_tpu.eval.artifacts import make_predictions_evidential, write_artifacts
from mimo_unet_tpu.train.checkpoint import load_checkpoint

NOISE_LEVELS = [0.00, 0.02, 0.04]


def main(args):
    enable_compile_cache()
    result_dir = Path(args.result_dir)
    result_dir.mkdir(parents=True, exist_ok=False)

    task, state = load_checkpoint(args.model_checkpoint_path)

    datasets = [("test", os.path.join(args.dataset_dir, "depth_test.h5"))]
    for dataset_name, dataset_path in datasets:
        for noise_level in NOISE_LEVELS:
            dataset = load_nyuv2_depth(dataset_path, normalize=True)
            print(f"Making predictions on {dataset_name} (eps={noise_level})...")
            preds = make_predictions_evidential(
                task, state.params, state.model_state, dataset,
                batch_size=args.batch_size, epsilon=noise_level,
            )
            write_artifacts(str(result_dir), dataset_name, noise_level, preds)
            print(f"Finished dataset `{dataset_name}` eps={noise_level}!")


if __name__ == "__main__":
    parser = ArgumentParser()
    parser.add_argument("--model_checkpoint_path", type=str, required=True)
    parser.add_argument("--result_dir", type=str, required=True)
    parser.add_argument("--dataset_dir", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=5)
    # accepted for reference-CLI compatibility; JAX picks the device
    parser.add_argument("--device", type=str, default=None)
    parser.add_argument("--processes", type=int, default=None)  # compat, unused
    main(parser.parse_args())
