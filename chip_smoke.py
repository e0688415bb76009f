"""Smoke test of the MIMO U-Net on an NVIDIA GPU, through the entry points a
user calls.

    python chip_smoke.py            # one card: the phases below
    python chip_smoke.py --four     # four cards: data-parallel + sharding checks

One process runs every phase in turn; the first failure ends the run with
a nonzero exit code and no result line.  The model is the flagship
configuration (NYUv2 depth: S=2 subnetworks, filter_base_count 21,
laplace_nll, bf16, 256x256 patches, batch 64 — reference Readme.md:61-79)
with random weights made from ``--seed``.

0. device: JAX's first device must be a GPU; prints the card's name and
   power limit as nvidia-smi reports them.
1. inference: flagship forward + uncertainty decomposition at B=64.
2. correctness at real widths (B=2, 256x256): the GPU against the CPU in
   f32, bf16 against f32, and what TF32 lets into default-precision f32.
3. trainer: ``Trainer.fit`` for one epoch (5 steps at B=64 + one
   validation pass) on synthetic NYUv2-shaped data, then the checkpoint
   must restore bit for bit.
4. evaluation: a 2-member ensemble of that checkpoint under FGSM.
5. the repository's ``gpu``-marked tests, in this process.

The last line of standard output is the JSON result
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK_DIR = os.path.join(ROOT, ".chip_smoke")

# ---- tolerances, each with its reason --------------------------------------
# GPU f32 at precision="highest" vs the same f32 forward on the CPU: the
# arithmetic is identical up to summation order (cuDNN's and XLA:CPU's conv
# algorithms, reduction trees).  The H100 showed 6.5e-8 relative L2; 1e-6
# leaves a 15x margin and is far inside the repo's 2e-4 torch-parity
# forward budget (README).
TOL_FWD_REL_L2 = 1e-6
# Gradients are another matter: backward through ~20 train-mode BatchNorm
# layers amplifies f32 rounding, so even the CPU's own f32 gradient sits
# up to ~4e-3 (worst leaf, relative L2) from a float64 evaluation of the
# same step.  A fixed bound below that is meaningless; the GPU's f32
# gradient must instead be as close to the float64 one as the CPU's f32
# gradient is, within this factor.  The H100 showed 2.5x on the worst
# leaf and 2.1x over all leaves (cuDNN's conv algorithms round otherwise
# than XLA:CPU's).
GRAD_NOISE_FACTOR = 4.0
# GPU bf16 vs GPU f32-highest forward: bf16 operands keep 8 bits of
# mantissa (relative rounding 2^-9 ~ 2e-3 per operand) through ~20
# conv+BN layers with f32 accumulation; the H100 showed 2.9e-3.
TOL_BF16_REL_L2 = 1e-2
# Four cards vs one card, f32-highest: the global-batch BatchNorm
# statistics and the gradient all-reduce change only reduction order.
# Forward quantities (step-1 loss, BatchNorm running statistics) are well
# conditioned, like the forward above.
TOL_MESH_FWD_REL = 1e-5
# Gradients and everything after the first Adam step inherit the
# backward's f32 sensitivity (see GRAD_NOISE_FACTOR): per leaf up to the
# ~1e-2 that separates two correct f32 evaluations, with a 5x margin; the
# whole gradient vector is better conditioned than its worst leaf.  Four
# H100s at global B=64 showed 1.8e-6 (worst leaf) and 3.5e-7 (all
# leaves): the per-card convs picked the same algorithms as the one-card
# run, which another batch need not do.  A global-batch BatchNorm that
# went per-card would fail the forward checks above by orders of
# magnitude.
TOL_MESH_GRAD_LEAF_REL = 5e-2
TOL_MESH_GRAD_REL = 1e-2
# Step-2 loss: the first Adam update is about lr * sign(g), so elements
# whose gradient is below that noise step either way; the mean loss over
# 64 x 2 x 256 x 256 pixels moves far less.
TOL_MESH_STEP2_LOSS_REL = 1e-4


class SmokeFailure(RuntimeError):
    """A phase found a wrong result."""


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Shapes of a smoke run: the flagship's unless a test shrinks them."""

    batch: int = 64  # reference training batch (Readme.md:61-79)
    size: int = 256  # patch side
    filter_base_count: int = 21
    compare_batch: int = 2  # phase 2
    train_steps: int = 5  # phase 3
    fgsm_batch: int = 8  # phase 4
    timing_reps: int = 10


FLAGSHIP = Sizes()


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def flagship_task(sizes: Sizes, compute_dtype="bfloat16", seed: int = 0):
    from mimo_unet_tpu.tasks import MimoUnetTask

    return MimoUnetTask(
        in_channels=3, out_channels=2, num_subnetworks=2,
        filter_base_count=sizes.filter_base_count, loss="laplace_nll",
        seed=seed, compute_dtype=compute_dtype,
    )


def synthetic_batch(seed: int, batch: int, size: int) -> dict:
    """NYUv2-shaped float batch in [0, 1]: RGB image, 1-channel depth."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {
        "image": rng.random((batch, size, size, 3), dtype=np.float32),
        "label": rng.random((batch, size, size, 1), dtype=np.float32),
    }


def rel_l2(got, want) -> float:
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def cosine(a, b) -> float:
    import numpy as np

    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))


def tree_errors(got, want) -> dict:
    """Relative L2 and cosine of two pytrees: of the worst leaf (named)
    and of all leaves as one vector.  Leaves that are exactly zero in both
    (conv biases that train-mode BatchNorm cancels) carry no direction
    and are skipped."""
    import jax
    import numpy as np

    res = {"leaf_rel": 0.0, "leaf_cos": 1.0, "leaf": None}
    flat_a, flat_b = [], []
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(want)):
        a = np.asarray(a, np.float64).ravel()
        b = np.asarray(b, np.float64).ravel()
        flat_a.append(a)
        flat_b.append(b)
        if not a.any() and not b.any():
            continue
        res["leaf_cos"] = min(res["leaf_cos"], cosine(a, b))
        if rel_l2(a, b) > res["leaf_rel"]:
            res["leaf_rel"] = rel_l2(a, b)
            res["leaf"] = jax.tree_util.keystr(path)
    flat_a, flat_b = np.concatenate(flat_a), np.concatenate(flat_b)
    res["rel"], res["cos"] = rel_l2(flat_a, flat_b), cosine(flat_a, flat_b)
    return res


def fmt_errors(e: dict) -> str:
    return (f"all leaves rel L2 {e['rel']:.3e} cos {e['cos']:.9f}; worst "
            f"leaf {e['leaf']} rel L2 {e['leaf_rel']:.3e} cos "
            f"{e['leaf_cos']:.9f}")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


# ---------------------------------------------------------------- phase 0

def check_devices(count: int):
    """The first ``count`` JAX devices, which must be GPUs."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SmokeFailure(
            f"JAX's first device is {devices[0].platform!r} "
            f"({devices[0].device_kind}), not a GPU")
    check(len(devices) >= count,
          f"needs {count} GPUs, JAX sees {len(devices)}")
    return devices[:count]


def print_card() -> None:
    """The card's name and power limit as nvidia-smi gives them (a child
    process, which stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    for line in out.strip().splitlines():
        print(line, flush=True)


# ---------------------------------------------------------------- phase 1

def make_forward(task):
    """The inference path of ``__graft_entry__.entry``: one image repeated
    across the subnetworks, then the uncertainty decomposition."""
    from mimo_unet_tpu.transforms import compute_uncertainties, repeat_subnetworks

    def forward(params, model_state, image):
        x = repeat_subnetworks(image, task.num_subnetworks)
        (p1, p2), _ = task.forward(params, model_state, x, train=False)
        return compute_uncertainties(task.loss_fn, p1, p2)

    return forward


def phase_inference(sizes: Sizes, seed: int) -> dict:
    import jax
    import numpy as np

    from mimo_unet_tpu.train.profiling import timed_per_exec

    task = flagship_task(sizes, seed=seed)
    state = task.init_state(steps_per_epoch=1)
    image = jax.device_put(
        synthetic_batch(seed, sizes.batch, sizes.size)["image"])
    args = (state.params, state.model_state, image)

    t0 = time.perf_counter()
    compiled = jax.jit(make_forward(task)).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    log(f"inference B={sizes.batch} memory_analysis: "
        f"{compiled.memory_analysis()}")
    mean, ale, epi = jax.block_until_ready(compiled(*args))
    step_s = timed_per_exec(compiled, *args, reps=sizes.timing_reps)

    want = (sizes.batch, sizes.size, sizes.size, task.out_channels // 2)
    for name, v in (("mean", mean), ("aleatoric_var", ale),
                    ("epistemic_var", epi)):
        check(v.shape == want, f"{name} shape {v.shape} != {want}")
        check(bool(np.isfinite(np.asarray(v)).all()), f"{name} not finite")
    ale_min, epi_min = float(ale.min()), float(epi.min())
    check(ale_min >= 0.0, f"aleatoric variance {ale_min} < 0")
    check(epi_min >= 0.0, f"epistemic variance {epi_min} < 0")
    res = {"compile_s": compile_s, "step_ms": 1e3 * step_s}
    log(f"phase 1 inference OK: compile {compile_s:.1f} s, step "
        f"{1e3 * step_s:.3f} ms at B={sizes.batch}, shapes {want}, "
        f"min aleatoric {ale_min:.3e}, min epistemic {epi_min:.3e}")
    return res


# ---------------------------------------------------------------- phase 2

def phase_correctness(sizes: Sizes, seed: int, device, cpu) -> dict:
    """Forward outputs and one train step's gradients, at the flagship's
    widths on a batch of ``sizes.compare_batch``."""
    import jax
    import jax.numpy as jnp

    from mimo_unet_tpu.transforms import repeat_subnetworks

    task32 = flagship_task(sizes, compute_dtype=None, seed=seed)
    task16 = flagship_task(sizes, compute_dtype="bfloat16", seed=seed)
    state = task32.init_state(steps_per_epoch=1)
    batch = synthetic_batch(seed + 1, sizes.compare_batch, sizes.size)
    rng = jax.random.key(seed)

    def forward(dev, task, precision):
        def f(params, model_state, image):
            x = repeat_subnetworks(image, task.num_subnetworks)
            return task.forward(params, model_state, x, train=False)[0]

        on = functools.partial(jax.device_put, device=dev)
        with jax.default_matmul_precision(precision):
            out = jax.jit(f)(on(state.params), on(state.model_state),
                             on(batch["image"]))
        return jax.device_get(out)

    def grads(dev, cast=None):
        args = jax.device_put((state, batch), dev)
        if cast is not None:
            args = jax.tree.map(
                lambda v: v.astype(cast) if v.dtype == jnp.float32 else v,
                args)
        with jax.default_matmul_precision("highest"):
            g, _ = jax.jit(task32.loss_and_grads)(*args,
                                                  jax.device_put(rng, dev))
        return jax.device_get(g)

    gpu_hi = forward(device, task32, "highest")

    def out_err(got, want=gpu_hi):
        return max(rel_l2(a, b) for a, b in zip(got, want))

    res = {
        "cpu_fwd_rel_l2": out_err(forward(cpu, task32, "highest")),
        "bf16_fwd_rel_l2": out_err(forward(device, task16, "highest")),
        "tf32_fwd_rel_l2": out_err(forward(device, task32, "default")),
    }
    g_gpu, g_cpu = grads(device), grads(cpu)
    # float64 except what the model keeps in float32 on purpose (BatchNorm
    # statistics, the output cast)
    with jax.enable_x64(True):
        g_64 = grads(cpu, jnp.float64)
    res["gpu_grad"] = tree_errors(g_gpu, g_64)
    res["cpu_grad"] = tree_errors(g_cpu, g_64)
    res["gpu_vs_cpu_grad"] = tree_errors(g_gpu, g_cpu)
    log(f"(a) f32-highest forward vs CPU: rel L2 "
        f"{res['cpu_fwd_rel_l2']:.3e} (tol {TOL_FWD_REL_L2:g})")
    log(f"(a) grads GPU f32 vs CPU f64: {fmt_errors(res['gpu_grad'])}")
    log(f"(a) grads CPU f32 vs CPU f64: {fmt_errors(res['cpu_grad'])} "
        f"(the GPU may be {GRAD_NOISE_FACTOR:g}x this far)")
    log(f"(a) grads GPU f32 vs CPU f32: {fmt_errors(res['gpu_vs_cpu_grad'])}")
    log(f"(b) bf16 vs f32-highest: forward rel L2 "
        f"{res['bf16_fwd_rel_l2']:.3e} (tol {TOL_BF16_REL_L2:g})")
    log(f"(c) f32 default precision vs f32-highest: forward rel L2 "
        f"{res['tf32_fwd_rel_l2']:.3e} (no bound: what TF32 lets in)")
    check(res["cpu_fwd_rel_l2"] <= TOL_FWD_REL_L2, "(a) forward vs CPU")
    for key in ("rel", "leaf_rel"):
        check(res["gpu_grad"][key]
              <= GRAD_NOISE_FACTOR * res["cpu_grad"][key],
              f"(a) gradient {key} vs float64")
    check(res["bf16_fwd_rel_l2"] <= TOL_BF16_REL_L2, "(b) bf16 forward")
    log("phase 2 correctness OK")
    return res


# ---------------------------------------------------------------- phase 3

def synthetic_nyuv2(seed: int, batch_size: int, size: int, n_train: int):
    """In-memory NYUv2-shaped data module made from a seed: uint8 RGB
    frames and uint8 depth, normalized on device as with
    ``--host_dtype uint8``; ``n_train`` training rows, one validation
    batch."""
    import numpy as np

    from mimo_unet_tpu.data.core import ArrayDataModule, ArrayDataset

    rng = np.random.default_rng(seed)

    def split(n):
        return ArrayDataset({
            "image": rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            "label": rng.integers(0, 256, (n, size, size, 1), dtype=np.uint8),
        })

    return ArrayDataModule(split(n_train), batch_size, val=split(batch_size))


def phase_trainer(sizes: Sizes, seed: int, ckpt_dir: str):
    """Returns the trained task and the checkpoint directory it saved."""
    import jax
    import numpy as np

    from mimo_unet_tpu.train.checkpoint import load_checkpoint
    from mimo_unet_tpu.train.logging import TSVLogger
    from mimo_unet_tpu.train.trainer import Trainer

    class CapturingLogger(TSVLogger):
        def __init__(self, root):
            super().__init__(root)
            self.rows = []

        def log_scalars(self, step, scalars):
            super().log_scalars(step, scalars)
            self.rows.append(dict(scalars))

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    task = flagship_task(sizes, seed=seed)
    dm = synthetic_nyuv2(seed, sizes.batch, sizes.size,
                         n_train=sizes.train_steps * sizes.batch)
    logger = CapturingLogger(ckpt_dir)
    trainer = Trainer(task, dm, max_epochs=1, checkpoint_path=ckpt_dir,
                      logger=logger, log_every_n_steps=1, log_images=False,
                      num_devices=1, seed=seed)
    t0 = time.perf_counter()
    state = trainer.fit()
    fit_s = time.perf_counter() - t0

    train_losses = [r["train_loss"] for r in logger.rows if "train_loss" in r]
    val_loss = trainer.history[-1].get("val_loss")
    check(int(state.step) == sizes.train_steps,
          f"state.step {int(state.step)} != {sizes.train_steps}")
    check(len(train_losses) == sizes.train_steps,
          f"{len(train_losses)} train losses logged")
    check(bool(np.isfinite(train_losses).all()), f"train loss {train_losses}")
    check(val_loss is not None and bool(np.isfinite(val_loss)),
          f"val loss {val_loss}")

    _, restored = load_checkpoint(trainer.ckpt.last_path)
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        check(np.array_equal(np.asarray(a), np.asarray(b)),
              "checkpoint does not restore the trained state bit for bit")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"phase 3 trainer OK: {sizes.train_steps} steps at B={sizes.batch} "
        f"+ validation in {fit_s:.1f} s (compile included); train losses "
        f"{[round(v, 5) for v in train_losses]}, val_loss {val_loss:.5f}; "
        f"checkpoint restores bit for bit; peak_bytes_in_use "
        f"{stats.get('peak_bytes_in_use', 'not reported')}")
    return task, trainer.ckpt.last_path


# ---------------------------------------------------------------- phase 4

def phase_evaluation(sizes: Sizes, seed: int, ckpt: str) -> dict:
    """2-member ensemble (the stacked program) of one checkpoint, FGSM at
    eps 0.02 against eps 0 on one batch."""
    import jax
    import numpy as np

    from mimo_unet_tpu.eval.fgsm import make_fgsm_fn
    from mimo_unet_tpu.models.ensemble import Ensemble
    from mimo_unet_tpu.transforms import repeat_subnetworks

    ens = Ensemble([ckpt, ckpt])
    batch = synthetic_batch(seed + 2, sizes.fgsm_batch, sizes.size)
    rng = jax.random.key(seed)
    label_rep = repeat_subnetworks(batch["label"], ens.output_width)
    nll = {}
    for eps in (0.0, 0.02):
        image, p1, p2 = make_fgsm_fn(ens, eps)(
            batch["image"], batch["label"], rng)
        for name, v in (("image", image), ("p1", p1), ("p2", p2)):
            check(bool(np.isfinite(np.asarray(v)).all()),
                  f"eps={eps}: {name} not finite")
        nll[eps] = float(ens.loss_fn(p1, p2, label_rep))
    check(nll[0.02] >= nll[0.0],
          f"FGSM lowered the NLL: {nll[0.02]} < {nll[0.0]}")
    log(f"phase 4 evaluation OK: 2-member ensemble, NLL eps=0 "
        f"{nll[0.0]:.5f}, eps=0.02 {nll[0.02]:.5f}")
    return nll


# ---------------------------------------------------------------- phase 5

def phase_gpu_tests() -> None:
    """The ``gpu``-marked tests, run in this process (a second process
    could not get the card's memory)."""
    import pytest

    os.environ["MIMO_TESTS_ON_DEVICE"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_gpu.py")])
    check(rc == 0, f"gpu-marked tests failed (pytest exit {rc})")
    log("phase 5 gpu-marked tests OK")


# ------------------------------------------------------------- four cards

def phase_four(sizes: Sizes, seed: int, devices) -> dict:
    """Data-parallel training on ``len(devices)`` cards against one card,
    then the sharded device cache and the spatially sharded forward."""
    import jax

    from __graft_entry__ import sharded_cache_check, spatial_forward_check
    from mimo_unet_tpu.parallel.mesh import (batch_sharding, make_mesh,
                                             replicated_sharding)

    n = len(devices)
    task = flagship_task(sizes, compute_dtype=None, seed=seed)
    tx = task.make_optimizer(steps_per_epoch=10)
    state0 = task.init_state(steps_per_epoch=10)
    batch = synthetic_batch(seed + 3, sizes.batch, sizes.size)
    rng = jax.random.key(seed)

    def two_steps(state_sh, data_sh):
        """Gradients of the first step, BatchNorm running statistics after
        it, and both steps' losses, with the given placements."""
        step = jax.jit(functools.partial(task.train_step, tx),
                       in_shardings=(state_sh, data_sh, state_sh),
                       out_shardings=(state_sh, state_sh, None))
        grads_fn = jax.jit(task.loss_and_grads,
                           in_shardings=(state_sh, data_sh, state_sh),
                           out_shardings=(state_sh, None))
        state = jax.device_put(state0, state_sh)
        b = jax.device_put(batch, data_sh)
        r = jax.device_put(rng, state_sh)
        grads, _ = grads_fn(state, b, r)
        state, logs, _ = step(state, b, r)
        bn_stats = jax.device_get(state.model_state)
        losses = [float(logs["train_loss"])]
        state, logs, _ = step(state, b, r)
        losses.append(float(logs["train_loss"]))
        return jax.device_get(grads), bn_stats, losses

    mesh = make_mesh(devices=devices)
    one = jax.sharding.SingleDeviceSharding(devices[0])
    with jax.default_matmul_precision("highest"):
        g_n, bn_n, loss_n = two_steps(replicated_sharding(mesh),
                                      batch_sharding(mesh))
        g_1, bn_1, loss_1 = two_steps(one, one)
        res = {"grad": tree_errors(g_n, g_1),
               "bn_rel": tree_errors(bn_n, bn_1)["leaf_rel"],
               "loss_rel": [abs(a - b) / abs(b)
                            for a, b in zip(loss_n, loss_1)]}
        log(f"{n} cards vs 1 at global B={sizes.batch}, f32-highest:")
        log(f"  step-1 loss {loss_n[0]!r} vs {loss_1[0]!r}, rel "
            f"{res['loss_rel'][0]:.3e} (tol {TOL_MESH_FWD_REL:g})")
        log(f"  BN running stats after step 1, worst leaf rel L2 "
            f"{res['bn_rel']:.3e} (tol {TOL_MESH_FWD_REL:g})")
        log(f"  step-1 grads: {fmt_errors(res['grad'])} (tol all "
            f"{TOL_MESH_GRAD_REL:g}, leaf {TOL_MESH_GRAD_LEAF_REL:g})")
        log(f"  step-2 loss {loss_n[1]!r} vs {loss_1[1]!r}, rel "
            f"{res['loss_rel'][1]:.3e} (tol {TOL_MESH_STEP2_LOSS_REL:g})")
        check(res["loss_rel"][0] <= TOL_MESH_FWD_REL, "mesh step-1 loss")
        check(res["bn_rel"] <= TOL_MESH_FWD_REL, "mesh BN statistics")
        check(res["grad"]["rel"] <= TOL_MESH_GRAD_REL, "mesh gradients")
        check(res["grad"]["leaf_rel"] <= TOL_MESH_GRAD_LEAF_REL,
              "mesh gradient leaf")
        check(res["loss_rel"][1] <= TOL_MESH_STEP2_LOSS_REL,
              "mesh step-2 loss")

        cache_msg = sharded_cache_check(mesh)
        # H-sharded forward on a 2 x (n/2) mesh vs unsharded: reduction
        # order only (per-shard conv shapes may pick other algorithms)
        res["spatial_err"] = spatial_forward_check(
            task, state0.params, state0.model_state,
            batch["image"][:4], n // 2, tol=TOL_MESH_FWD_REL)
    log(f"{cache_msg}; spatial(2x{n // 2}) forward max rel err "
        f"{res['spatial_err']:.3e} (tol {TOL_MESH_FWD_REL:g})")
    log(f"four-card phase OK on {n} devices")
    return res


# ------------------------------------------------------------------- main

def result_line(device, count: int) -> str:
    """The run's last line: ``{"ok": true, "device": {...}}`` with the
    device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": count}})


def run_single(sizes: Sizes, seed: int, device) -> None:
    import jax

    phase_inference(sizes, seed)
    phase_correctness(sizes, seed, device, jax.devices("cpu")[0])
    _, ckpt = phase_trainer(sizes, seed, os.path.join(WORK_DIR, "ckpt"))
    phase_evaluation(sizes, seed, ckpt)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--four", action="store_true",
                        help="run only the four-card data-parallel and "
                             "sharding checks")
    args = parser.parse_args(argv)

    # phase 2 compares against the CPU backend: keep it available
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    import jax

    from mimo_unet_tpu.utils import enable_compile_cache

    enable_compile_cache()
    devices = check_devices(4 if args.four else 1)
    print_card()
    log(f"devices: {jax.devices()}")
    if args.four:
        phase_four(FLAGSHIP, args.seed, devices)
        count = len(devices)
    else:
        run_single(FLAGSHIP, args.seed, devices[0])
        phase_gpu_tests()
        count = len(jax.devices())
    print(result_line(devices[0], count), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
