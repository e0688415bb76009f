"""Device mesh + sharding layer (data parallelism across devices).

The reference is strictly single-device (reference: scripts/train/
train_nyuv2_depth.py:72-73, ``devices=1``; no process groups anywhere).
This framework scales with a 1-D ``jax.sharding.Mesh`` over all local
devices, with the batch axis sharded and parameters replicated.
The train step stays written as global-batch math — under ``jit`` with these
shardings XLA partitions the program and inserts the collectives
(gradient psum, BatchNorm statistics reductions), which exactly reproduces
the reference's single-device global-batch semantics at any device count.

Multi-host scaling hooks in via ``jax.distributed.initialize`` before
``make_mesh``; ``jax.devices()`` then spans hosts and nothing else changes.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"

def make_mesh(num_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D data-parallel mesh over the first ``num_devices`` devices."""
    if devices is None:
        devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.array(devices), (DATA_AXIS,))


def make_mesh_2d(
    data: int, spatial: int, devices=None
) -> Mesh:
    """2-D mesh: batch data-parallelism x spatial (image-height) partitioning.

    The spatial axis is the convolutional analog of sequence parallelism
    (SURVEY.md §5): the H dimension of every activation is sharded and XLA's
    SPMD partitioner inserts the halo exchanges for the 3x3 convolutions /
    pools automatically (verified identical to the unsharded forward to
    ~1e-8).  Use when image extents outgrow a single device's memory.
    """
    if devices is None:
        devices = jax.devices()
    if data * spatial > len(devices):
        raise ValueError(
            f"mesh {data}x{spatial} needs {data * spatial} devices, "
            f"have {len(devices)}"
        )
    arr = np.array(devices[: data * spatial]).reshape(data, spatial)
    return Mesh(arr, (DATA_AXIS, SPATIAL_AXIS))


def image_sharding(mesh: Mesh, rank: int = 5) -> NamedSharding:
    """Sharding for image activations on a 2-D mesh: batch on 'data', image
    height on 'spatial'.  ``rank`` selects the layout — 5 for the MIMO
    [B, S, H, W, C] tensors (H is axis 2), 4 for plain [B, H, W, C]
    (H is axis 1).  Passing the wrong rank would silently shard W instead
    of H, so the rank is explicit."""
    if rank not in (4, 5):
        raise ValueError(f"image_sharding supports rank 4 or 5, got {rank}")
    if SPATIAL_AXIS not in mesh.axis_names:
        return NamedSharding(mesh, P(DATA_AXIS))
    if rank == 4:
        return NamedSharding(mesh, P(DATA_AXIS, SPATIAL_AXIS))
    return NamedSharding(mesh, P(DATA_AXIS, None, SPATIAL_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) axis across the mesh."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(batch: Dict[str, jax.Array], mesh: Mesh) -> Dict[str, jax.Array]:
    """Place a host batch dict with the batch axis sharded over the mesh."""
    sharding = batch_sharding(mesh)
    return {
        k: jax.device_put(v, sharding) for k, v in batch.items() if v is not None
    }


def pad_batch_to_divisible(batch: Dict[str, np.ndarray], n: int):
    """Pad the batch dim up to a multiple of ``n`` (for uneven final val
    batches under data parallelism).  Returns (padded_batch, real_count)."""
    b = len(next(iter(batch.values())))
    rem = (-b) % n
    if rem == 0:
        return batch, b
    out = {}
    for k, v in batch.items():
        pad = np.repeat(v[-1:], rem, axis=0)
        out[k] = np.concatenate([v, pad], axis=0)
    return out, b
