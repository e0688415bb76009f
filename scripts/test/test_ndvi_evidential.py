"""Evaluate an evidential U-Net on SEN12TP NDVI.

Mirrors reference scripts/test/test_ndvi_evidential.py:150-209: single
checkpoint, NIG uncertainties, SEN12TP patch windowing, calibration on a
50% pixel subsample.
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
    make_predictions_evidential,
)
from mimo_unet_tpu.train.checkpoint import load_checkpoint


def main(args):
    enable_compile_cache()
    result_dir = Path(args.result_dir)
    result_dir.mkdir(parents=True, exist_ok=False)

    task, state = load_checkpoint(args.model_checkpoint_path)

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
    preds = make_predictions_evidential(
        task, state.params, state.model_state, dataset, batch_size=args.batch_size
    )
    inputs, y_preds, y_trues, aleatoric_vars, epistemic_vars, combined_vars = preds

    print("Saving predictions ...")
    np.save(result_dir / "inputs.npy", inputs)
    np.save(result_dir / "y_preds.npy", y_preds)
    np.save(result_dir / "y_trues.npy", y_trues)
    np.save(result_dir / "aleatoric_vars.npy", aleatoric_vars)
    np.save(result_dir / "epistemic_vars.npy", epistemic_vars)

    df = convert_to_dataframe(
        y_preds, y_trues, aleatoric_vars, epistemic_vars, combined_vars
    )
    df.to_pickle(result_dir / "df_pixels.pkl")
    create_precision_recall(df).to_csv(result_dir / "precision_recall.csv", index=False)
    create_calibration(df, subsample=0.5).to_csv(
        result_dir / "calibration.csv", index=False
    )
    print("Finished processing dataset!")


if __name__ == "__main__":
    parser = ArgumentParser()
    parser.add_argument("--model_checkpoint_path", type=str, required=True)
    parser.add_argument("--result_dir", type=str, required=True)
    parser.add_argument("--dataset_dir", type=str, required=True)
    # accepted for reference-CLI compatibility; JAX picks the device
    parser.add_argument("--device", type=str, default=None)
    parser.add_argument("--processes", type=int, default=2)  # compat, unused
    parser.add_argument("--batch_size", type=int, default=5)
    parser.add_argument("--patch_size", type=int, default=256)
    parser.add_argument("--stride", type=int, default=249)
    main(parser.parse_args())
