"""Checkpoint/resume with the checkpoint-carries-hparams contract.

The reference relies on Lightning's ``save_hyperparameters`` so that
``load_from_checkpoint(path)`` rebuilds the model with zero config
(reference: mimo/models/mimo_unet.py:83-87, ensemble.py:42).  Here a
checkpoint directory holds ``state/arrays.npz`` (params, model_state,
opt_state, loss buffer, step — one array per pytree leaf, keyed by its
tree path) plus ``hparams.json``, and ``load_checkpoint`` restores both
the state and the task object — the same zero-config contract, which the
ensemble/eval tooling depends on.  The writer needs numpy only.

Also supported: loading PyTorch reference ``.ckpt`` files directly via
``mimo_unet_tpu.interop`` (so users can migrate trained models).
"""

from __future__ import annotations

import dataclasses
import json
import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

HPARAMS_FILE = "hparams.json"
STATE_DIR = "state"
STATE_FILE = "arrays.npz"


def _state_file(path: str) -> str:
    return os.path.join(path, STATE_DIR, STATE_FILE)


def _replace_atomically(final: str, write) -> None:
    """Write a side file through ``write(file)``, flush it to disk, then
    rename it into place: a reader sees the previous complete file or the
    new one, never a torn one."""
    os.makedirs(os.path.dirname(final), exist_ok=True)
    partial = final + ".partial"
    with open(partial, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(partial, final)


def _host_leaves(state) -> Dict[str, np.ndarray]:
    """Copy every leaf to host memory, keyed by its tree path."""
    leaves = jax.tree_util.tree_leaves_with_path(state)
    host = jax.device_get([leaf for _, leaf in leaves])
    return {jax.tree_util.keystr(p): np.asarray(v)
            for (p, _), v in zip(leaves, host)}


def _task_from_hparams(hparams: Dict[str, Any]):
    from mimo_unet_tpu.tasks.evidential import EvidentialUnetTask
    from mimo_unet_tpu.tasks.mimo import MimoUnetTask

    kind = hparams.get("task", "mimo_unet")
    cls = {"mimo_unet": MimoUnetTask, "evidential_unet": EvidentialUnetTask}[kind]
    field_names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in hparams.items() if k in field_names})


def save_checkpoint(path: str, state, hparams: Dict[str, Any],
                    writer: Optional[ThreadPoolExecutor] = None
                    ) -> Optional[Future]:
    """Write ``state/arrays.npz`` + ``hparams.json`` under ``path``.

    The state is always copied to host before this returns, so training
    may donate or overwrite it.  With ``writer`` (a one-thread executor),
    the file write runs there and overlaps the following train steps —
    the equivalent of the reference's non-blocking ModelCheckpoint
    callback (train_nyuv2_depth.py:22-36); the returned future completes
    once both files are in place.

    hparams.json commits AFTER the state does, never before: a crash
    mid-write must not leave fresh hparams (with e.g. new "best"
    metadata) next to a stale state file that a later resume would read
    as consistent."""
    path = os.path.abspath(path)
    host = _host_leaves(state)

    hp_bytes = json.dumps(hparams, indent=2, default=str).encode()

    def write():
        _replace_atomically(_state_file(path),
                            lambda f: np.savez(f, **host))
        _replace_atomically(os.path.join(path, HPARAMS_FILE),
                            lambda f: f.write(hp_bytes))

    if writer is None:
        write()
        return None
    return writer.submit(write)


def load_hparams(path: str) -> Dict[str, Any]:
    with open(os.path.join(os.path.abspath(path), HPARAMS_FILE)) as f:
        return json.load(f)


def load_checkpoint(path: str, steps_per_epoch: int = 1):
    """Restore (task, TrainState) from a checkpoint directory.

    ``steps_per_epoch`` is only needed to rebuild the optimizer pytree
    structure; the restored opt_state overwrites its values.

    If ``path`` points at a PyTorch Lightning ``.ckpt`` file from the
    reference implementation, it is converted on the fly (optimizer state
    starts fresh in that case).
    """
    if path.endswith(".ckpt") and os.path.isfile(path):
        return _load_reference_ckpt(path, steps_per_epoch)

    path = os.path.abspath(path)
    task = _task_from_hparams(load_hparams(path))
    abstract = jax.eval_shape(lambda: task.init_state(steps_per_epoch))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(abstract)
    values = []
    with np.load(_state_file(path)) as arrays:
        for p, want in leaves:
            v = arrays[jax.tree_util.keystr(p)]
            if v.dtype != want.dtype:
                # np.savez stores extension dtypes (bfloat16) as raw bytes
                v = v.view(want.dtype)
            if v.shape != want.shape:
                raise ValueError(
                    f"{path}: leaf {jax.tree_util.keystr(p)} has shape "
                    f"{v.shape}, the task expects {want.shape}")
            values.append(jnp.asarray(v))
    return task, jax.tree_util.tree_unflatten(treedef, values)


def _load_reference_ckpt(path: str, steps_per_epoch: int):
    """Convert a reference Lightning checkpoint into (task, TrainState)."""
    from mimo_unet_tpu.interop import load_reference_checkpoint
    from mimo_unet_tpu.tasks.mimo import TrainState

    cfg, params, model_state, hparams = load_reference_checkpoint(path)
    task_hparams = dict(hparams)
    task_hparams.setdefault("task", "mimo_unet")
    task = _task_from_hparams(task_hparams)
    base = task.init_state(steps_per_epoch)
    return task, TrainState(
        step=base.step,
        params=params,
        model_state=model_state,
        opt_state=base.opt_state,
        loss_buffer=base.loss_buffer,
    )


class CheckpointManager:
    """save_last + best-by-val_loss retention, like the reference's
    ModelCheckpoint callbacks (train_nyuv2_depth.py:22-36)."""

    def __init__(self, root: str, hparams: Dict[str, Any],
                 async_save: bool = True):
        self.root = os.path.abspath(root)
        self.hparams = hparams
        self.best_val_loss = float("inf")
        # one writer thread: saves run in submission order, so a later
        # save of the same directory never lands under an earlier one
        self._writer = ThreadPoolExecutor(max_workers=1) if async_save else None
        self._pending: List[Future] = []
        os.makedirs(self.root, exist_ok=True)

    def wait_until_finished(self) -> None:
        """Block until every dispatched save is on disk (call before
        reading a just-written checkpoint or exiting); re-raises a failed
        write."""
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    @property
    def last_path(self) -> str:
        return os.path.join(self.root, "last")

    @property
    def best_path(self) -> str:
        return os.path.join(self.root, "best")

    def _save(self, path: str, state, hparams) -> None:
        fut = save_checkpoint(path, state, hparams, writer=self._writer)
        if fut is not None:
            self._pending.append(fut)

    def save_last(self, state) -> None:
        self._save(self.last_path, state, self.hparams)

    def maybe_save_best(self, state, val_loss: float, epoch: int, step: int) -> bool:
        if val_loss < self.best_val_loss:
            self.best_val_loss = float(val_loss)
            hp = dict(self.hparams)
            hp["best"] = {"epoch": epoch, "step": step, "val_loss": float(val_loss)}
            self._save(self.best_path, state, hp)
            return True
        return False

    def restore_best_tracking(self) -> float:
        """Reload best_val_loss from best/hparams.json (written by
        maybe_save_best) so resumed runs never regress best/.  Called by the
        trainer on resume only — a fresh fit into a reused directory starts
        tracking from scratch, like a new Lightning ModelCheckpoint."""
        if os.path.exists(_state_file(self.best_path)):
            try:
                best = load_hparams(self.best_path).get("best", {})
            except FileNotFoundError:
                best = {}
            if "val_loss" in best:
                self.best_val_loss = float(best["val_loss"])
        return self.best_val_loss

    def has_last(self) -> bool:
        return os.path.exists(_state_file(self.last_path))
