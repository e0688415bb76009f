"""Inference-time ensembling: multi-checkpoint + MC-dropout.

Rebuilt from reference mimo/models/ensemble.py:35-115:
  * load N checkpoints (zero-config via the hparams-carrying checkpoint
    contract; reference Lightning .ckpt files also load via interop),
  * optionally re-activate dropout at eval ("MC dropout", ensemble.py:54-66
    — here just ``mc_dropout=True`` on the forward; BatchNorm stays in eval
    mode, exactly like the reference which only flips Dropout modules),
  * every member runs max(1, monte_carlo_steps) stochastic passes; all
    predictions concatenate on the subnetwork axis,
  * return raw (p1, p2) or the uncertainty decomposition.

Serving shape (vs the reference's Python loops, ensemble.py:95-105):
MC passes fold into the batch axis of ONE forward (dropout masks are drawn
per sample, so a tiled batch yields independent MC samples), and
consecutive same-architecture members run as ONE vmapped program over
stacked parameter pytrees — members x passes execute as a single fused
XLA computation instead of M*mc sequential dispatches.

Reference quirks intentionally NOT reproduced (SURVEY.md §7): predictions
stay on device (the reference's per-pass ``.cpu()`` breaks FGSM-through-
ensemble autograd, ensemble.py:101-102), and labels repeat to the actual
output width so FGSM works with MC dropout too.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from mimo_unet_tpu.transforms import compute_uncertainties, repeat_subnetworks


class Ensemble:
    """Callable ensemble of trained MIMO U-Net tasks."""

    def __init__(
        self,
        checkpoint_paths: Sequence[str],
        monte_carlo_steps: int = 0,
        return_raw_predictions: bool = False,
    ):
        from mimo_unet_tpu.train.checkpoint import load_checkpoint

        if not checkpoint_paths:
            raise ValueError("need at least one checkpoint")
        self.members: List[Tuple[object, dict, dict]] = []
        for path in checkpoint_paths:
            task, state = load_checkpoint(path)
            self.members.append((task, state.params, state.model_state))
        self.monte_carlo_steps = monte_carlo_steps
        self.return_raw_predictions = return_raw_predictions

        names = {task.loss_fn.name for task, _, _ in self.members}
        if len(names) > 1:
            raise ValueError(f"ensemble members disagree on loss: {names}")
        self.loss_fn = self.members[0][0].loss_fn

        mc = max(1, monte_carlo_steps)
        # consecutive same-architecture members -> one vmapped program over
        # stacked params (concat order preserved: runs are consecutive);
        # each run is (first member index, jitted fn, params, model_state)
        self._runs = []
        i = 0
        while i < len(self.members):
            sig = self._signature(self.members[i][0])
            j = i + 1
            while j < len(self.members) and self._signature(
                    self.members[j][0]) == sig:
                j += 1
            task, params, mstate = self.members[i]
            if j - i > 1:
                fn = self._build_stacked_fn(task, mc, j - i)
                params, mstate = (
                    jax.tree.map(lambda *xs: jnp.stack(xs),
                                 *[self.members[k][n] for k in range(i, j)])
                    for n in (1, 2))
            else:
                fn = jax.jit(self._member_fn_body(task, mc))
            self._runs.append((i, fn, params, mstate))
            i = j

    @staticmethod
    def _signature(task):
        # type(task) distinguishes task classes with identical configs and
        # loss names (e.g. a future task subclass overriding forward) —
        # only same-class members may share one vmapped forward
        return (type(task), task.model_config, task.loss)

    @property
    def num_subnetworks(self) -> int:
        """Total subnetworks across members (reference ensemble.py:68-70).
        Note: the concatenated prediction axis is this times max(1, mc)."""
        return sum(task.num_subnetworks for task, _, _ in self.members)

    @property
    def output_width(self) -> int:
        return self.num_subnetworks * max(1, self.monte_carlo_steps)

    def _member_fn_body(self, task, mc: int):
        """MC passes folded into the batch: dropout masks are per-sample
        (ops/dropout.py), so a tiled batch is mc independent samples in one
        forward — the prediction axis stays mc-major per member, matching
        the reference's per-pass concat order (ensemble.py:99-105)."""
        mc_dropout = self.monte_carlo_steps > 0

        def member_fn(params, model_state, image, rng):
            b = image.shape[0]
            x = repeat_subnetworks(image, task.num_subnetworks)
            if mc > 1:
                x = jnp.concatenate([x] * mc, axis=0)
            (p1, p2), _ = task.forward(
                params, model_state, x, train=False, rng=rng,
                mc_dropout=mc_dropout,
            )
            if mc > 1:
                def fold(p):
                    p = p.reshape((mc, b) + p.shape[1:])
                    return jnp.moveaxis(p, 0, 1).reshape(
                        (b, mc * p.shape[2]) + p.shape[3:])
                p1, p2 = fold(p1), fold(p2)
            return p1, p2

        return member_fn

    def _build_stacked_fn(self, task, mc: int, n_members: int):
        """One program for a run of same-architecture members: vmap the
        member forward over stacked parameter pytrees."""
        body = self._member_fn_body(task, mc)
        vm = jax.vmap(body, in_axes=(0, 0, None, 0))

        def stacked_fn(params, mstate, image, rng):
            rngs = jax.random.split(rng, n_members)
            p1, p2 = vm(params, mstate, image, rngs)  # [M, B, mc*S, ...]
            p1 = jnp.moveaxis(p1, 0, 1).reshape(
                (p1.shape[1], -1) + p1.shape[3:])
            p2 = jnp.moveaxis(p2, 0, 1).reshape(
                (p2.shape[1], -1) + p2.shape[3:])
            return p1, p2

        return jax.jit(stacked_fn)

    def raw_forward(
        self, image: jax.Array, rng: Optional[jax.Array] = None
    ) -> Tuple[jax.Array, jax.Array]:
        """[B,H,W,C] -> (p1, p2) each [B, S_total*mc, H, W, C_out/2]."""
        if rng is None:
            rng = jax.random.key(0)
        p1s, p2s = [], []
        for start, fn, params, mstate in self._runs:
            p1, p2 = fn(params, mstate, image, jax.random.fold_in(rng, start))
            p1s.append(p1)
            p2s.append(p2)
        return jnp.concatenate(p1s, axis=1), jnp.concatenate(p2s, axis=1)

    def __call__(self, image: jax.Array, rng: Optional[jax.Array] = None):
        p1, p2 = self.raw_forward(image, rng)
        if self.return_raw_predictions:
            return p1, p2
        return compute_uncertainties(self.loss_fn, p1, p2)

    def predict(
        self,
        images,
        batch_size: int = 32,
        rng: Optional[jax.Array] = None,
    ):
        """Serving convenience: run any number of images through the
        ensemble in fixed-size batches (one compiled program; the final
        partial batch is padded and trimmed).  Returns numpy
        (mean, aleatoric_var, epistemic_var) stacked over all inputs."""
        import numpy as np

        if rng is None:
            rng = jax.random.key(0)
        images = np.asarray(images)
        n = images.shape[0]
        outs = []
        for start in range(0, n, batch_size):
            chunk = images[start : start + batch_size]
            real = chunk.shape[0]
            if real < batch_size:
                pad = np.repeat(chunk[-1:], batch_size - real, axis=0)
                chunk = np.concatenate([chunk, pad], axis=0)
            p1, p2 = self.raw_forward(
                jnp.asarray(chunk), jax.random.fold_in(rng, start)
            )
            mean, ale, epi = compute_uncertainties(self.loss_fn, p1, p2)
            outs.append(
                (np.asarray(mean)[:real], np.asarray(ale)[:real],
                 np.asarray(epi)[:real])
            )
        return tuple(np.concatenate(parts, axis=0) for parts in zip(*outs))
