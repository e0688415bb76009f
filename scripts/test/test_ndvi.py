"""Evaluate a MIMO U-Net ensemble on SEN12TP NDVI.

Mirrors reference scripts/test/test_ndvi.py:131-224: raw SEN12TP dataset
with VV/VH inputs -> NDVI target, patch/stride windowing and the clipping
transform; artifacts inputs/y_preds/y_trues/aleatoric_vars/epistemic_vars
.npy, df_pixels.pkl, precision_recall.csv, calibration.csv (calibration on
a 50% pixel subsample, test_ndvi.py:195).
"""

import os
import sys
from argparse import ArgumentParser
from pathlib import Path

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from mimo_unet_tpu.utils import enable_compile_cache
from mimo_unet_tpu.data.sen12tp import (
    Patchsize,
    Sen12tpDataset,
    default_clipping_transform,
    min_max_transform,
)
from mimo_unet_tpu.eval.artifacts import (
    convert_to_dataframe,
    create_calibration,
    create_precision_recall,
    make_predictions,
)
from mimo_unet_tpu.models.ensemble import Ensemble


def main(args):
    enable_compile_cache()
    result_dir = Path(args.result_dir)
    result_dir.mkdir(parents=True, exist_ok=False)

    model = Ensemble(
        checkpoint_paths=args.model_checkpoint_paths,
        monte_carlo_steps=args.monte_carlo_steps,
        return_raw_predictions=True,
    )

    dataset = Sen12tpDataset(
        path=args.dataset_dir,
        patch_size=Patchsize(args.patch_size, args.patch_size),
        stride=args.stride,
        model_inputs=["VV_sigma0", "VH_sigma0"],
        model_targets=["NDVI"],
        transform=min_max_transform,
        clip_transform=default_clipping_transform,
    )

    print("Making predictions ...")
    preds = make_predictions(model, dataset, batch_size=args.batch_size)
    inputs, y_preds, y_trues, aleatoric_vars, epistemic_vars, combined_vars = preds

    print("Saving predictions ...")
    np.save(result_dir / "inputs.npy", inputs)
    np.save(result_dir / "y_preds.npy", y_preds)
    np.save(result_dir / "y_trues.npy", y_trues)
    np.save(result_dir / "aleatoric_vars.npy", aleatoric_vars)
    np.save(result_dir / "epistemic_vars.npy", epistemic_vars)

    print("Computing metrics ...")
    df = convert_to_dataframe(
        y_preds, y_trues, aleatoric_vars, epistemic_vars, combined_vars
    )
    df.to_pickle(result_dir / "df_pixels.pkl")

    print("Creating data for precision-recall plot ...")
    create_precision_recall(df).to_csv(result_dir / "precision_recall.csv", index=False)

    print("Creating data for calibration plot ...")
    create_calibration(df, subsample=0.5).to_csv(
        result_dir / "calibration.csv", index=False
    )
    print("Finished processing dataset!")


if __name__ == "__main__":
    parser = ArgumentParser()
    parser.add_argument("--model_checkpoint_paths", nargs="+", type=str, required=True)
    parser.add_argument("--result_dir", type=str, required=True)
    parser.add_argument("--dataset_dir", type=str, required=True)
    parser.add_argument("--monte_carlo_steps", type=int, default=0)
    # accepted for reference-CLI compatibility; JAX picks the device
    parser.add_argument("--device", type=str, default=None)
    parser.add_argument("--processes", type=int, default=2)  # compat, unused
    parser.add_argument("--batch_size", type=int, default=5)
    parser.add_argument("--patch_size", type=int, default=256)
    parser.add_argument("--stride", type=int, default=249)
    main(parser.parse_args())
