"""chip_smoke.py on the CPU: its phases at a tiny width, its refusal to
run without a GPU, its result line, and the compile-cache helper it
shares with every entry point."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke
from mimo_unet_tpu import utils

TINY = chip_smoke.Sizes(batch=4, size=32, filter_base_count=4,
                        compare_batch=2, train_steps=2, fgsm_batch=2,
                        timing_reps=2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_phase_inference_tiny():
    res = chip_smoke.phase_inference(TINY, seed=0)
    assert res["compile_s"] > 0 and res["step_ms"] > 0


def test_phase_correctness_tiny():
    """On the CPU both sides of every comparison are the same program, so
    each error is (near) zero and within its bound."""
    cpu = jax.devices("cpu")[0]
    res = chip_smoke.phase_correctness(TINY, 0, cpu, cpu)
    assert res["cpu_fwd_rel_l2"] <= 1e-7
    assert res["gpu_vs_cpu_grad"]["rel"] <= 1e-7
    # the float64 reference sits a little way from either f32 gradient
    assert 0 < res["cpu_grad"]["rel"] < 1e-3
    assert res["bf16_fwd_rel_l2"] <= chip_smoke.TOL_BF16_REL_L2


def test_phase_trainer_and_evaluation_tiny(tmp_path):
    task, ckpt = chip_smoke.phase_trainer(TINY, 0, str(tmp_path / "ckpt"))
    assert os.path.exists(os.path.join(ckpt, "hparams.json"))
    nll = chip_smoke.phase_evaluation(TINY, 0, ckpt)
    assert nll[0.02] >= nll[0.0]


def test_phase_four_on_four_virtual_devices():
    """The --four comparison on 4 CPU devices: data-parallel steps equal
    the single-device ones up to reduction order."""
    res = chip_smoke.phase_four(TINY, 0, jax.devices()[:4])
    assert res["grad"]["rel"] <= chip_smoke.TOL_MESH_GRAD_REL
    assert res["bn_rel"] <= chip_smoke.TOL_MESH_FWD_REL


def test_check_devices_refuses_cpu():
    with pytest.raises(chip_smoke.SmokeFailure, match="not a GPU"):
        chip_smoke.check_devices(1)


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_main_exits_nonzero_on_cpu():
    proc = _run(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "not a GPU" in proc.stderr


def test_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(str(tmp_path), "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_result_line_form():
    dev = jax.devices()[0]
    line = chip_smoke.result_line(dev, 4)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": 4}}


def test_tree_errors_names_worst_leaf_and_skips_zero_leaves():
    a = {"w": np.array([1.0, 2.0]), "v": np.array([3.0]), "b": np.zeros(3)}
    b = {"w": np.array([1.0, 2.0 + 1e-6]), "v": np.array([3.0]),
         "b": np.zeros(3)}
    e = chip_smoke.tree_errors(a, b)
    assert e["leaf"] == "['w']"
    assert e["leaf_cos"] == pytest.approx(1.0)
    assert 0 < e["rel"] < e["leaf_rel"] < 1e-6


class TestCompileCache:
    def test_env_var_wins_and_nothing_is_set(self, monkeypatch):
        calls = []
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/cache")
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        assert utils.enable_compile_cache() == "/somewhere/cache"
        assert calls == []

    def test_unset_uses_checkout_dir(self, monkeypatch):
        calls = []
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        path = utils.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert calls == [("jax_compilation_cache_dir", path)]

    def test_path_is_fixed(self, monkeypatch):
        """The same directory in every process: no pid, time or temp dir
        in it, so a later run finds what an earlier one cached."""
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(jax.config, "update", lambda *a: None)
        first = utils.enable_compile_cache()
        assert utils.enable_compile_cache() == first
        assert str(os.getpid()) not in first
        assert first.startswith(REPO + os.sep)
