"""Evaluate a MIMO U-Net ensemble on NYUv2 depth with FGSM sweeps.

Mirrors the reference eval CLI and artifact set (reference scripts/test/
test_nyuv2_depth.py:173-259; artifacts documented in its Readme.md:85-94):
for each (dataset, epsilon in {0.00, 0.02, 0.04}) writes inputs/y_preds/
y_trues/aleatoric_vars/epistemic_vars .npy, per-pixel metrics.pkl,
precision_recall.csv and calibration.csv.

``--device`` and ``--processes`` are accepted for CLI compatibility; the
calibration ppf sweep is vectorized (no process pool) and compute runs on
the JAX default device.
"""

import os
import sys
from argparse import ArgumentParser
from pathlib import Path

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from mimo_unet_tpu.utils import enable_compile_cache
from mimo_unet_tpu.data.nyuv2 import load_nyuv2_depth
from mimo_unet_tpu.eval.artifacts import make_predictions, write_artifacts
from mimo_unet_tpu.models.ensemble import Ensemble

NOISE_LEVELS = [0.00, 0.02, 0.04]


def main(args):
    enable_compile_cache()
    result_dir = Path(args.result_dir)
    result_dir.mkdir(parents=True, exist_ok=False)

    model = Ensemble(
        checkpoint_paths=args.model_checkpoint_paths,
        monte_carlo_steps=args.monte_carlo_steps,
        return_raw_predictions=True,
    )

    # extra (name, path) dataset slots, e.g. an OOD split (the reference
    # keeps a commented-out ("ood", apolloscape_test.h5) entry here —
    # reference test_nyuv2_depth.py:252-255); each produces the full
    # artifact set under its own name prefix
    datasets = [("test", os.path.join(args.dataset_dir, "depth_test.h5"))]
    for spec in args.extra_dataset or []:
        name, _, path = spec.partition("=")
        if not path:
            raise SystemExit(
                f"--extra_dataset expects NAME=PATH, got {spec!r}")
        datasets.append((name, path))
    for dataset_name, dataset_path in datasets:
        for noise_level in NOISE_LEVELS:
            dataset = load_nyuv2_depth(dataset_path, normalize=True)
            print(f"Making predictions on {dataset_name} (eps={noise_level})...")
            preds = make_predictions(
                model, dataset, batch_size=args.batch_size, epsilon=noise_level
            )
            print(f"Writing artifacts for {dataset_name} (eps={noise_level})...")
            write_artifacts(str(result_dir), dataset_name, noise_level, preds)
            print(f"Finished dataset `{dataset_name}` eps={noise_level}!")


if __name__ == "__main__":
    parser = ArgumentParser()
    parser.add_argument("--model_checkpoint_paths", nargs="+", type=str, required=True)
    parser.add_argument("--result_dir", type=str, required=True)
    parser.add_argument("--dataset_dir", type=str, required=True)
    parser.add_argument("--monte_carlo_steps", type=int, default=0)
    parser.add_argument("--batch_size", type=int, default=5)
    # accepted for reference-CLI compatibility; JAX picks the device
    parser.add_argument("--device", type=str, default=None)
    parser.add_argument("--processes", type=int, default=None)  # compat, unused
    parser.add_argument(
        "--extra_dataset", nargs="*", default=None, metavar="NAME=PATH",
        help="additional evaluation datasets (e.g. ood=/data/apolloscape_"
             "test.h5), each evaluated at every noise level",
    )
    main(parser.parse_args())
