"""Train the evidential (NIG) U-Net on NYUv2 depth.

Mirrors reference scripts/train/train_nyuv2_depth_evidential.py:36-109
(fixed out_channels=4, no MIMO flags).
"""

import os
import sys
from argparse import ArgumentParser

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from mimo_unet_tpu.utils import enable_compile_cache
from mimo_unet_tpu.cli import (
    add_evidential_model_args,
    add_trainer_args,
    build_evidential_task,
    run_training,
)
from mimo_unet_tpu.data.nyuv2 import NYUv2DepthDataModule


def main(args):
    enable_compile_cache()
    dm = NYUv2DepthDataModule.from_args(args)
    task = build_evidential_task(args, in_channels=3, out_channels=4)
    run_training(args, task, dm, monitor_mode="depth")


if __name__ == "__main__":
    parser = ArgumentParser()
    parser = add_trainer_args(parser, project="MIMO NYUv2Depth", max_epochs=100)
    parser = NYUv2DepthDataModule.add_model_specific_args(parser)
    parser = add_evidential_model_args(parser)
    main(parser.parse_args())
