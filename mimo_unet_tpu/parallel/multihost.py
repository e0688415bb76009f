"""Multi-host scaling hooks.

The reference has no distributed execution at all (single GPU,
scripts/train/train_nyuv2_depth.py:72-73).  This framework's data
parallelism is mesh-based (parallel/mesh.py); scaling beyond one host is
jax.distributed + the same mesh over all processes' devices:

    from mimo_unet_tpu.parallel.multihost import initialize_multihost
    initialize_multihost("host0:1234", num_processes=2, process_id=rank)
    mesh = make_mesh()                  # now spans all hosts' devices

Under jit with the batch sharded on the mesh, XLA inserts the gradient and
batch-norm reductions across every device of every host — no further code
changes, because every step function is written as global-batch math.

Per-host input feeding: each process should feed its local shard;
``host_local_batch_slice`` gives the [start, stop) range of the global
batch this process owns under the canonical batch sharding.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """jax.distributed.initialize with pass-through args.

    Safe to call when already initialized (no-op) or on a single process
    with no cluster env (returns without initializing).
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (RuntimeError, ValueError) as e:
        # already initialized, or single-process with no cluster env
        if "already" not in str(e).lower() and num_processes not in (None, 1):
            raise


def host_local_batch_slice(global_batch: int) -> Tuple[int, int]:
    """[start, stop) of the global batch this process feeds under the
    canonical 1-D batch sharding (devices enumerated process-major)."""
    n_proc = jax.process_count()
    if global_batch % n_proc:
        raise ValueError(
            f"global batch {global_batch} must be divisible by the process "
            f"count {n_proc}"
        )
    per = global_batch // n_proc
    start = jax.process_index() * per
    return start, start + per
