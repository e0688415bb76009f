"""Device-memory capacity ladder: make every batch size compile.

At a large enough batch the flagship train step no longer fits device
memory — a capacity failure, not a kernel bug: the saved full-res
residuals scale linearly with batch.  The reference framework never sees
this wall at compile time because torch releases activations eagerly
under AMP and OOMs at runtime instead; a jitted program is sized when it
compiles, so the fallback has to be structural.

`make_train_step` AOT-compiles the jitted train step and, on a
memory-capacity rejection, retries with progressively more
rematerialization (``MimoUNetConfig.remat``: "none" -> "enc" -> "all" —
jax.checkpoint over the encoder, then also core+decoder).  Remat replays
the same ops in the backward, so numerics are unchanged; the cost is the
wrapped sections' extra forward FLOPs.  Slower is fine — failing is not.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax

_HBM_OOM_MARKERS = (
    "ran out of memory in memory space hbm",
    "exceeded hbm capacity",
    "resource_exhausted",
    "allocating larger than the hbm",
)

RUNGS = ("none", "enc", "all")


def is_hbm_oom(err: BaseException) -> bool:
    """True when a compile failure is a memory capacity rejection (the only
    failure class the remat ladder can fix)."""
    msg = str(err).lower()
    return any(m in msg for m in _HBM_OOM_MARKERS)


def make_train_step(
    task,
    tx,
    state,
    batch,
    rng,
    *,
    donate: bool = True,
    rungs: Tuple[str, ...] = RUNGS,
    verbose: bool = True,
):
    """Compile a train step that fits device memory, laddering ``task.remat``.

    Returns ``(jitted_step, task_used)``; ``jitted_step(state, batch,
    rng)`` has the usual (new_state, logs, outputs) signature.  The AOT
    probe compile is cached by the persistent compilation cache, so the
    returned jit's own first call is cheap.  Raises the original error
    for non-capacity failures, or the last error if every rung OOMs.
    """
    start = rungs.index(task.remat) if task.remat in rungs else 0
    last_err: Optional[BaseException] = None
    for rung in rungs[start:]:
        t = dataclasses.replace(task, remat=rung)
        step = jax.jit(
            functools.partial(t.train_step, tx, with_outputs=False),
            donate_argnums=(0,) if donate else (),
        )
        try:
            step.lower(state, batch, rng).compile()
            if verbose and rung != task.remat:
                print(f"[capacity] train step needs remat={rung!r} "
                      f"to fit device memory at this batch size")
            return step, t
        except Exception as e:  # noqa: BLE001 — classify, then re-raise
            if not is_hbm_oom(e):
                raise
            last_err = e
    raise last_err
