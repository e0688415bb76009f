"""Train MIMO U-Net on SEN12TP (e.g. VV/VH -> NDVI).

Mirrors the reference CLI (reference scripts/train/train_ndvi.py:86-118;
usage in its Readme.md:33-56), e.g.:

    python scripts/train/train_ndvi.py \
        --checkpoint_path ~/ckpts --dataset_dir ~/data/sen12tp \
        --seed 1 -i VV_sigma0 -i VH_sigma0 -t NDVI \
        --num_subnetworks 2 --filter_base_count 30 --batch_size 32
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
from mimo_unet_tpu.data.sen12tp import add_datamodule_args, get_datamodule


def main(args):
    enable_compile_cache()
    dm = get_datamodule(args)
    task = build_mimo_task(
        args,
        in_channels=len(dm.model_inputs),
        out_channels=len(dm.model_targets) * args.num_loss_function_params,
    )
    run_training(
        args, task, dm, monitor_mode="sen12tp", monitor_targets=dm.model_targets
    )


if __name__ == "__main__":
    parser = ArgumentParser()
    parser = add_trainer_args(parser, project="MIMO Sen12TP", max_epochs=40)
    parser = add_datamodule_args(parser)
    parser = add_mimo_model_args(parser)
    main(parser.parse_args())
