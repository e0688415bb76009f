"""Train MIMO U-Net on NYUv2 depth.

Mirrors the reference CLI (reference scripts/train/train_nyuv2_depth.py:
88-123; usage documented in its Readme.md:61-79), e.g.:

    python scripts/train/train_nyuv2_depth.py \
        --checkpoint_path ~/ckpts --dataset_dir ~/data/depth \
        --seed 1 --num_subnetworks 2 --filter_base_count 21 \
        --batch_size 64 --loss laplace_nll --learning_rate 0.001
"""

import os
import sys
from argparse import ArgumentParser

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from mimo_unet_tpu.utils import enable_compile_cache
from mimo_unet_tpu.cli import (
    add_mimo_model_args,
    add_trainer_args,
    build_mimo_task,
    run_training,
)
from mimo_unet_tpu.data.nyuv2 import NYUv2DepthDataModule


def main(args):
    enable_compile_cache()
    dm = NYUv2DepthDataModule.from_args(args)
    task = build_mimo_task(args, in_channels=3, out_channels=args.num_loss_function_params)
    run_training(args, task, dm, monitor_mode="depth")


if __name__ == "__main__":
    parser = ArgumentParser()
    parser = add_trainer_args(parser, project="MIMO NYUv2Depth", max_epochs=100)
    parser = NYUv2DepthDataModule.add_model_specific_args(parser)
    parser = add_mimo_model_args(parser)
    main(parser.parse_args())
