"""Data pipeline core.

The reference feeds the GPU through torch DataLoader worker processes
(reference: mimo/tasks/depth/nyuv2_datamodule.py:52-60).  The device must
never wait on the host, so the pipeline here is:

  host numpy arrays -> vectorized batch slicing (no per-item Python work)
    -> background-thread prefetch queue -> ``jax.device_put`` (async)

Datasets are dicts of numpy arrays sharing the leading dimension
(``ArrayDataset``); per-epoch shuffling is one permutation, and a batch is
one fancy-index slice — there is no per-sample ``__getitem__`` hot path to
parallelize, which replaces the reference's ``num_workers`` machinery.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import jax


Batch = Dict[str, np.ndarray]


class ArrayDataset:
    """A dict of same-leading-dim numpy arrays with vectorized batch access.

    Batch slicing goes through the native multithreaded gather
    (data/_native/gather.cc) when available; numpy fancy indexing otherwise.
    """

    def __init__(self, data: Dict[str, np.ndarray]):
        lens = {k: len(v) for k, v in data.items()}
        if len(set(lens.values())) > 1:
            raise ValueError(f"mismatched leading dims: {lens}")
        self.data = data

    def __len__(self) -> int:
        return len(next(iter(self.data.values())))

    def __getitem__(self, index) -> Batch:
        if isinstance(index, np.ndarray) and index.ndim == 1:
            from mimo_unet_tpu.data import _native

            out = {}
            for k, v in self.data.items():
                got = _native.gather_rows(v, index) if isinstance(v, np.ndarray) else None
                out[k] = got if got is not None else v[index]
            return out
        return {k: v[index] for k, v in self.data.items()}

    @property
    def keys(self):
        return self.data.keys()

    def map(self, fn: Callable[[str, np.ndarray], np.ndarray]) -> "ArrayDataset":
        return ArrayDataset({k: fn(k, v) for k, v in self.data.items()})


# batch keys whose values are semantic (0/1 validity, masks) rather than
# intensity data: never rescaled by device_normalize
_NO_RESCALE_KEYS = ("mask", "valid")


def device_normalize(batch: Batch) -> Batch:
    """Normalize uint8 batch entries to [0, 1] float32 on device.

    Input staging: datasets may keep host arrays as uint8 (4x less host
    memory, host copy and H2D transfer than float32); the /255 lands
    on-device inside the jitted step.  float arrays pass through
    unchanged, so the default float32 pipeline is unaffected.  Mask-like
    keys ("mask", "valid") convert dtype only — a uint8 0/1 mask must stay
    0/1, not become 0/255ths.
    """
    import jax.numpy as jnp

    def norm(k, v):
        if v is None or v.dtype != jnp.uint8:
            return v
        v = v.astype(jnp.float32)
        return v if k in _NO_RESCALE_KEYS else v / 255.0

    return {k: norm(k, v) for k, v in batch.items()}


def iterate_batches(
    dataset: ArrayDataset,
    batch_size: int,
    *,
    shuffle: bool = False,
    drop_last: bool = False,
    seed: Optional[int] = None,
    epoch: int = 0,
) -> Iterator[Batch]:
    """Yield batch dicts.  Shuffling reseeds per epoch (seed + epoch)."""
    for idx in iterate_index_batches(
        len(dataset), batch_size, shuffle=shuffle, drop_last=drop_last,
        seed=seed, epoch=epoch,
    ):
        yield dataset[idx]


def iterate_index_batches(
    n: int,
    batch_size: int,
    *,
    shuffle: bool = False,
    drop_last: bool = False,
    seed: Optional[int] = None,
    epoch: int = 0,
) -> Iterator[np.ndarray]:
    """Yield per-batch index arrays (the sampling half of
    ``iterate_batches``, for device-resident datasets where the gather
    itself happens on-chip)."""
    if shuffle:
        rng = np.random.default_rng(None if seed is None else seed + epoch)
        order = rng.permutation(n)
    else:
        order = np.arange(n)
    end = (n // batch_size) * batch_size if drop_last else n
    for start in range(0, end, batch_size):
        yield order[start : start + batch_size]


class DeviceDataset:
    """Dataset pinned in device memory with on-device batch gather.

    Input staging one step past ``host_dtype="uint8"``: the whole dataset
    is ``jax.device_put`` once (uint8 arrays stay uint8, so NYUv2's full
    train split costs ~1.2 MB/frame of device memory) and each step's
    batch assembly becomes a `jnp.take` INSIDE the jitted train step —
    per-step host work shrinks to drawing ``batch_size`` indices.  The
    reference holds the same arrays in host RAM and re-assembles every
    batch on the CPU through DataLoader workers (reference
    mimo/datasets/nyuv2.py:20-24, nyuv2_datamodule.py:52-60).

    Use ``gather(idx)`` inside a jitted step, then ``device_normalize``
    (which the tasks already apply) for the uint8 -> [0,1] float32 step.

    With ``mesh`` (>1 data-parallel devices), the rows are pinned
    row-SHARDED across the mesh's data axis (per-device shard pinning)
    and sampling becomes shard-local.  This is deliberately NOT torch's
    ``DistributedSampler`` recipe: torch draws a fresh GLOBAL permutation
    each epoch and strides it across ranks (each rank's subset and the
    wrap-pad duplicates change per epoch), which is impossible with rows
    physically pinned per device.  Instead the wrapped index space
    [0, ceil(n/D)*D) is randomized ONCE with the base ``seed`` — both
    which rows are wrap-duplicated and which partition each row lands in
    — then each shard permutes its fixed partition per epoch
    (iterate_sharded_index_batches).  Per-step gradients stay unbiased;
    the difference from torch is that the partition is fixed for the run
    (docs/MIGRATION.md "Not carried over").  ``gather`` runs under
    ``shard_map`` so every device indexes only its own shard (no
    cross-device collectives on the sample path).
    """

    def __init__(self, dataset: ArrayDataset, device=None, mesh=None,
                 seed: int = 0):
        self.n = len(dataset)
        self.mesh = mesh if (mesh is not None and mesh.size > 1) else None
        if self.mesh is None:
            self.n_shards = 1
            self.n_local = self.n
            self.data = {
                k: (jax.device_put(v, device) if device is not None
                    else jax.device_put(v))
                for k, v in dataset.data.items()
                if v is not None
            }
            return
        from mimo_unet_tpu.parallel.mesh import DATA_AXIS

        d = int(self.mesh.shape[DATA_AXIS])
        self.n_shards = d
        self.n_local = -(-self.n // d)  # ceil: wrapped pad to divisible
        rng = np.random.default_rng(seed)
        # randomize which rows get wrap-duplicated, then scatter partition
        # membership so shards are not dataset-order-contiguous (see class
        # docstring; the partition itself stays fixed for the run)
        wrapped = rng.permutation(self.n)[np.arange(self.n_local * d) % self.n]
        rng.shuffle(wrapped)
        self.wrapped = wrapped
        sharding = jax.NamedSharding(self.mesh, jax.sharding.PartitionSpec(
            DATA_AXIS))
        self.data = {
            k: jax.device_put(np.ascontiguousarray(v[wrapped]), sharding)
            for k, v in dataset.data.items()
            if v is not None
        }

    def __len__(self) -> int:
        return self.n

    @property
    def nbytes(self) -> int:
        return sum(int(np.asarray(v).dtype.itemsize) * int(np.prod(v.shape))
                   for v in self.data.values())

    def gather(self, idx, data=None) -> Batch:
        """On-device batch gather (jit-safe).

        Unsharded: idx [B] global rows -> dict of [B, ...].
        Sharded: idx [D, B/D] shard-LOCAL rows (row d for data-device d)
        -> dict of [B, ...] batch-sharded arrays; each device gathers
        from its own pinned shard only.

        ``data`` lets a jitted caller pass the pinned arrays as an
        explicit operand (so the step's data dependence is visible in its
        signature rather than captured by closure); defaults to
        ``self.data``."""
        import jax.numpy as jnp

        if data is None:
            data = self.data
        if self.mesh is None:
            return {k: jnp.take(v, idx, axis=0) for k, v in data.items()}
        from mimo_unet_tpu.parallel.mesh import DATA_AXIS

        P = jax.sharding.PartitionSpec

        def _local(data, ix):
            ix = ix.reshape(-1)
            return {k: v[ix] for k, v in data.items()}

        return jax.shard_map(
            _local, mesh=self.mesh,
            in_specs=(P(DATA_AXIS), P(DATA_AXIS, None)),
            out_specs=P(DATA_AXIS),
        )(data, idx)

    def index_sharding(self):
        """Sharding for the [D, B/D] per-step index array (None when
        unsharded — the plain [B] global index array needs no placement)."""
        if self.mesh is None:
            return None
        from mimo_unet_tpu.parallel.mesh import DATA_AXIS

        return jax.NamedSharding(
            self.mesh, jax.sharding.PartitionSpec(DATA_AXIS, None))


def iterate_sharded_index_batches(
    n: int,
    n_shards: int,
    batch_size: int,
    *,
    shuffle: bool = False,
    seed: Optional[int] = None,
    epoch: int = 0,
) -> Iterator[np.ndarray]:
    """Shard-local sampling for a mesh-sharded DeviceDataset: yields
    [D, B/D] int32 arrays of shard-LOCAL rows.  Each shard permutes its
    FIXED partition per epoch (the partition was randomized once at
    DeviceDataset construction — see its docstring for how this differs
    from torch's per-epoch global repartition); batches are always full
    (drop_last on the per-shard remainder)."""
    assert batch_size % n_shards == 0, (batch_size, n_shards)
    bd = batch_size // n_shards
    n_local = -(-n // n_shards)
    rng = np.random.default_rng(None if seed is None else seed + epoch)
    if shuffle:
        orders = np.stack([rng.permutation(n_local) for _ in range(n_shards)])
    else:
        orders = np.tile(np.arange(n_local), (n_shards, 1))
    for start in range(0, (n_local // bd) * bd, bd):
        yield np.ascontiguousarray(
            orders[:, start:start + bd].astype(np.int32))


def dataset_nbytes(dataset: ArrayDataset) -> int:
    """Host-side size estimate for the device-cache eligibility check."""
    return sum(v.nbytes for v in dataset.data.values() if v is not None)


def device_cache_budget_bytes() -> Optional[int]:
    """Free-memory estimate for the device-cache capacity gate.

    Uses PJRT ``memory_stats``: 60% of (limit - in_use), so model params,
    activations, and the optimizer state keep their headroom.  None on
    the CPU, which reports no limit, meaning "no gate".  An accelerator
    that reports no memory limit is an error: guessing a budget would
    hide the device."""
    dev = jax.local_devices()[0]
    stats = dev.memory_stats() or {}
    limit = stats.get("bytes_limit")
    if limit:
        return int(0.6 * (limit - stats.get("bytes_in_use", 0)))
    if dev.platform == "cpu":
        return None
    raise RuntimeError(
        f"{dev.platform} device {dev.device_kind!r} reports no memory "
        "limit; pass an explicit device_cache_budget")


class PartialDeviceDataset:
    """Capacity fallback for ``DeviceDataset``: pin what fits, stream the
    rest.

    The reference never faces this decision — it holds the split in host
    RAM and feeds through 32 DataLoader workers (reference
    mimo/datasets/nyuv2.py:20-24, nyuv2_datamodule.py:52-60).  Pinning the
    split in device memory is strictly bounded, so a split that does not
    fit must not silently lose the fast path: a FIXED random subset of
    rows (chosen once with ``seed``) is pinned on device; the remainder
    stays host-side.

    Epoch semantics: every row is visited exactly once per epoch.  Cached
    rows are served as full on-chip-gather batches, host rows as uploaded
    batches, in a pseudo-random interleaved batch order (reseeded per
    epoch).  Deviation from the uniform sampler (documented in
    docs/MIGRATION.md): each batch is drawn entirely from one stratum
    (cached / streamed) of a fixed partition, like the mesh-sharded
    sampler's fixed per-device partitions; per-step gradients remain
    unbiased within the stratum and the epoch remains a permutation of
    the dataset.  Upload traffic per epoch scales with the uncached
    fraction only.
    """

    def __init__(self, dataset: ArrayDataset, max_bytes: int, device=None,
                 seed: int = 0):
        self.dataset = dataset
        n = len(dataset)
        row_bytes = max(dataset_nbytes(dataset) / max(n, 1), 1)
        n_cache = min(n, int(max_bytes // row_bytes))
        rng = np.random.default_rng(seed)
        perm = rng.permutation(n)
        self.cached_rows = np.sort(perm[:n_cache])
        self.host_rows = perm[n_cache:]
        sub = ArrayDataset({
            k: np.ascontiguousarray(v[self.cached_rows])
            for k, v in dataset.data.items() if v is not None
        })
        self.cached = DeviceDataset(sub, device=device)

    def __len__(self) -> int:
        return len(self.dataset)

    @property
    def n_cached(self) -> int:
        return len(self.cached_rows)

    @property
    def nbytes(self) -> int:
        return self.cached.nbytes

    def epoch_batches(self, batch_size: int, *, seed: int = 0,
                      epoch: int = 0, shuffle: bool = True,
                      drop_last: bool = False):
        """Yield ("cached", local_idx [B]) / ("host", batch dict) items.

        Cached batches are always full ``batch_size`` (the < B remainder
        of the cached stream is served through the host stream instead —
        the rows live in host RAM too, so no row is dropped and the
        jitted gather step keeps one static shape).  The host stream's
        own ragged tail batch is yielded unless ``drop_last`` (the
        trainer passes drop_last=True, matching its host-fed path and
        torch's train DataLoader; which rows land in the dropped tail
        reshuffles per epoch)."""
        rng = np.random.default_rng(None if seed is None else seed + epoch)
        nc = self.n_cached
        if shuffle:
            c_order = rng.permutation(nc)
            h_extra = self.cached_rows[c_order[(nc // batch_size)
                                               * batch_size:]]
            c_order = c_order[: (nc // batch_size) * batch_size]
            h_order = np.concatenate([self.host_rows, h_extra]).astype(
                np.int64)
            rng.shuffle(h_order)
        else:
            c_order = np.arange((nc // batch_size) * batch_size)
            h_extra = self.cached_rows[(nc // batch_size) * batch_size:]
            h_order = np.concatenate([self.host_rows, h_extra]).astype(
                np.int64)
        n_cb = len(c_order) // batch_size
        if drop_last:
            n_hb = len(h_order) // batch_size
        else:
            n_hb = -(-len(h_order) // batch_size) if len(h_order) else 0
        tags = np.array(["c"] * n_cb + ["h"] * n_hb)
        if shuffle:
            rng.shuffle(tags)
        ci = hi = 0
        for t in tags:
            if t == "c":
                yield ("cached",
                       c_order[ci * batch_size:(ci + 1) * batch_size]
                       .astype(np.int32))
                ci += 1
            else:
                rows = h_order[hi * batch_size:(hi + 1) * batch_size]
                yield ("host", self.dataset[rows])
                hi += 1


def prefetch_to_device(
    iterator: Iterator[Batch],
    *,
    size: int = 2,
    sharding=None,
    chunk: int = 1,
) -> Iterator[Batch]:
    """Overlap host batch assembly with device compute.

    A background thread drains ``iterator`` (h5 slicing, shuffling, copies)
    into a bounded queue; the consumer issues the (async-dispatch)
    ``jax.device_put`` — optionally with a ``NamedSharding`` so batches land
    already sharded across the mesh.  The device transfer stays on the
    consumer thread, so a device_put never races a compile on another
    thread.

    ``chunk``: upload ``chunk`` batches as ONE ``device_put`` and yield
    on-device slices: fewer, bigger uploads amortize a fixed per-transfer
    cost by ``1/chunk``.  Trailing batches whose count doesn't fill a chunk are
    uploaded as a smaller chunk.  The per-step device-side slice is one
    batch-sized copy (memory-speed).  Batches inside a chunk must share
    shapes (the dataloaders' drop_last handles ragged tails).
    """
    q: "queue.Queue" = queue.Queue(maxsize=max(size, chunk))
    _END = object()

    def producer():
        try:
            for batch in iterator:
                q.put({k: v for k, v in batch.items() if v is not None})
        except Exception as e:  # surface producer errors to the consumer
            q.put(e)
        finally:
            q.put(_END)

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    def _put(host):
        return {
            k: (jax.device_put(v, sharding)
                if sharding is not None else jax.device_put(v))
            for k, v in host.items()
        }

    if chunk <= 1:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, Exception):
                raise item
            yield _put(item)
        return

    pend: list = []
    done = False
    while not done:
        while len(pend) < chunk:
            item = q.get()
            if item is _END:
                done = True
                break
            if isinstance(item, Exception):
                raise item
            pend.append(item)
        if not pend:
            return
        k0 = next(iter(pend[0]))
        sizes = [len(p[k0]) for p in pend]
        dev = _put({k: np.concatenate([p[k] for p in pend], axis=0)
                    for k in pend[0]})
        off = 0
        for n in sizes:
            yield {k: v[off:off + n] for k, v in dev.items()}
            off += n
        pend = []


class DataModule:
    """Train/val/test split container mirroring the reference DataModule
    surface (setup + {train,val,test}_dataloader), minus torch."""

    batch_size: int

    def setup(self) -> None:
        raise NotImplementedError

    def train_dataset(self) -> ArrayDataset:
        raise NotImplementedError

    def val_dataset(self) -> Optional[ArrayDataset]:
        return None

    def test_dataset(self) -> Optional[ArrayDataset]:
        return None

    # dataloader-style iterators -------------------------------------------

    def train_batches(self, epoch: int, seed: int = 0) -> Iterator[Batch]:
        return iterate_batches(
            self.train_dataset(), self.batch_size,
            shuffle=True, drop_last=True, seed=seed, epoch=epoch,
        )

    def val_batches(self) -> Iterator[Batch]:
        ds = self.val_dataset()
        if ds is None:
            return iter(())
        return iterate_batches(ds, self.batch_size, drop_last=False)

    def test_batches(self) -> Iterator[Batch]:
        ds = self.test_dataset()
        if ds is None:
            return iter(())
        return iterate_batches(ds, self.batch_size, drop_last=False)


class ArrayDataModule(DataModule):
    """DataModule over datasets already in host memory (synthetic data made
    from a seed, or arrays a caller loaded itself)."""

    def __init__(self, train: ArrayDataset, batch_size: int,
                 val: Optional[ArrayDataset] = None,
                 test: Optional[ArrayDataset] = None):
        self.batch_size = batch_size
        self._train, self._val, self._test = train, val, test

    def setup(self) -> None:
        pass

    def train_dataset(self) -> ArrayDataset:
        return self._train

    def val_dataset(self) -> Optional[ArrayDataset]:
        return self._val

    def test_dataset(self) -> Optional[ArrayDataset]:
        return self._test
