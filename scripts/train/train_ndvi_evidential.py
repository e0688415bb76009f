"""Train the evidential (NIG) U-Net on SEN12TP.

Mirrors reference scripts/train/train_ndvi_evidential.py (evidential model,
SEN12TP datamodule; out_channels = 4 * num_targets).
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
from mimo_unet_tpu.data.sen12tp import add_datamodule_args, get_datamodule


def main(args):
    enable_compile_cache()
    dm = get_datamodule(args)
    task = build_evidential_task(
        args,
        in_channels=len(dm.model_inputs),
        out_channels=4 * len(dm.model_targets),
    )
    run_training(
        args, task, dm, monitor_mode="sen12tp", monitor_targets=dm.model_targets
    )


if __name__ == "__main__":
    parser = ArgumentParser()
    parser = add_trainer_args(parser, project="MIMO Sen12TP", max_epochs=40)
    parser = add_datamodule_args(parser)
    parser = add_evidential_model_args(parser)
    main(parser.parse_args())
