"""End-to-end CLI tests: train -> eval -> artifacts, via subprocess (CPU)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from make_fixtures import make_nyuv2_h5, make_sen12tp_tiles

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_script(script, *args, timeout=900):
    # a JAX_COMPILATION_CACHE_DIR in the environment passes through;
    # without it the scripts cache in <checkout>/.jax_cache
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="",  # single CPU device (conftest exports an 8-device flag)
    )
    cmd = [sys.executable, os.path.join(REPO, script), *map(str, args)]
    proc = subprocess.run(
        cmd, capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO
    )
    assert proc.returncode == 0, f"{script} failed:\n{proc.stdout}\n{proc.stderr}"
    return proc


@pytest.mark.slow
class TestTrainEvalCLI:
    def test_nyuv2_train_then_eval(self, tmp_path):
        data_dir = make_nyuv2_h5(os.path.join(tmp_path, "data"), n=8, h=32, w=32)
        ckpt_dir = os.path.join(tmp_path, "ckpt")
        os.makedirs(ckpt_dir)

        run_script(
            "scripts/train/train_nyuv2_depth.py",
            "--checkpoint_path", ckpt_dir, "--dataset_dir", data_dir,
            "--seed", 1, "--max_epochs", 1, "--batch_size", 4,
            "--num_subnetworks", 2, "--filter_base_count", 4,
            "--precision", "f32", "--log_every_n_steps", 1,
        )
        assert os.path.isdir(os.path.join(ckpt_dir, "last"))
        assert os.path.exists(os.path.join(ckpt_dir, "last", "hparams.json"))
        with open(os.path.join(ckpt_dir, "last", "hparams.json")) as f:
            hp = json.load(f)
        assert hp["num_subnetworks"] == 2 and hp["loss"] == "laplace_nll"

        result_dir = os.path.join(tmp_path, "results")
        run_script(
            "scripts/test/test_nyuv2_depth.py",
            "--model_checkpoint_paths", os.path.join(ckpt_dir, "last"),
            "--result_dir", result_dir, "--dataset_dir", data_dir,
            "--batch_size", 4,
            # the reference's commented-out OOD dataset slot
            # (test_nyuv2_depth.py:252-255) as a live flag
            "--extra_dataset", "ood=" + os.path.join(data_dir, "depth_test.h5"),
        )
        for name in ("test", "ood"):
            for eps in ("0.0", "0.02", "0.04"):
                for suffix in ("y_preds.npy", "calibration.csv",
                               "precision_recall.csv", "metrics.pkl"):
                    path = os.path.join(result_dir, f"{name}_{eps}_{suffix}")
                    assert os.path.exists(path), path
        preds = np.load(os.path.join(result_dir, "test_0.0_y_preds.npy"))
        assert preds.shape == (4, 32, 32)

        proc = run_script(
            "scripts/test/measure_inference_speed.py",
            "--model_checkpoint_paths", os.path.join(ckpt_dir, "last"),
            "--in_channels", 3, "--height", 32, "--width", 32,
            "--repetitions", 5,
        )
        assert "mean:" in proc.stdout and "std:" in proc.stdout

    def test_evidential_train_then_eval_and_speed(self, tmp_path):
        data_dir = make_nyuv2_h5(os.path.join(tmp_path, "data"), n=8, h=32, w=32)
        ckpt_dir = os.path.join(tmp_path, "ckpt")
        os.makedirs(ckpt_dir)
        run_script(
            "scripts/train/train_nyuv2_depth_evidential.py",
            "--checkpoint_path", ckpt_dir, "--dataset_dir", data_dir,
            "--seed", 2, "--max_epochs", 1, "--batch_size", 4,
            "--filter_base_count", 4, "--precision", "f32",
            "--log_every_n_steps", 0,
        )
        result_dir = os.path.join(tmp_path, "results")
        run_script(
            "scripts/test/test_nyuv2_depth_evidential.py",
            "--model_checkpoint_path", os.path.join(ckpt_dir, "last"),
            "--result_dir", result_dir, "--dataset_dir", data_dir,
            "--batch_size", 4,
        )
        assert os.path.exists(os.path.join(result_dir, "test_0.04_calibration.csv"))

    def test_ndvi_train_mimo(self, tmp_path):
        data_dir = make_sen12tp_tiles(os.path.join(tmp_path, "sen"), n_tiles=1,
                                      size=96, splits=("train", "val"))
        ckpt_dir = os.path.join(tmp_path, "ckpt")
        os.makedirs(ckpt_dir)
        run_script(
            "scripts/train/train_ndvi.py",
            "--checkpoint_path", ckpt_dir, "--dataset_dir", data_dir,
            "--seed", 3, "--max_epochs", 1, "--batch_size", 2,
            "--patch_size", "64", "--stride", "32",
            "-i", "VV_sigma0", "-i", "VH_sigma0", "-t", "NDVI",
            "--num_subnetworks", 2, "--filter_base_count", 4,
            "--precision", "f32", "--log_every_n_steps", 1,
        )
        with open(os.path.join(ckpt_dir, "last", "hparams.json")) as f:
            hp = json.load(f)
        assert hp["task"] == "mimo_unet"
        assert hp["in_channels"] == 2 and hp["out_channels"] == 2
        # sen12tp-mode monitor images were written
        img_dir = os.path.join(ckpt_dir, "images")
        assert os.path.isdir(img_dir) and len(os.listdir(img_dir)) > 0

    def test_ndvi_train_evidential(self, tmp_path):
        data_dir = make_sen12tp_tiles(os.path.join(tmp_path, "sen"), n_tiles=1,
                                      size=96, splits=("train", "val"))
        ckpt_dir = os.path.join(tmp_path, "ckpt")
        os.makedirs(ckpt_dir)
        run_script(
            "scripts/train/train_ndvi_evidential.py",
            "--checkpoint_path", ckpt_dir, "--dataset_dir", data_dir,
            "--seed", 1, "--max_epochs", 1, "--batch_size", 2,
            "--patch_size", "64", "--stride", "32",
            "-i", "VV_sigma0", "-i", "VH_sigma0", "-t", "NDVI",
            "--filter_base_count", 4, "--precision", "f32",
            "--log_every_n_steps", 0,
        )
        with open(os.path.join(ckpt_dir, "last", "hparams.json")) as f:
            hp = json.load(f)
        assert hp["task"] == "evidential_unet"
        assert hp["in_channels"] == 2 and hp["out_channels"] == 4
