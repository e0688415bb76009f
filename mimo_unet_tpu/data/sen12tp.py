"""SEN12TP: multiband raster tiles -> patch/stride windowed samples.

The reference delegates this to the external ``sen12tp`` package
(reference: mimo/tasks/sen12tp/sen12tp_datamodule.py:16-31 builds
``SEN12TPDataModuleV2(dataset_dir, patch_size=Patchsize(p, p), stride,
model_inputs, model_targets, transform=min_max_transform)``; the eval
script additionally passes ``clip_transform=default_clipping_transform``,
scripts/test/test_ndvi.py:152-160).  SURVEY.md §2 C14: the windowing engine
must be implemented natively here.

Native contract:
  * A dataset directory contains per-tile multiband rasters; supported
    containers are ``.npy`` ([H, W, B] with a sidecar ``bands.json`` listing
    band names), ``.npz`` (arrays keyed by band name), and ``.tif`` via
    imageio when available.
  * ``model_inputs`` / ``model_targets`` name bands (``VV_sigma0``,
    ``VH_sigma0``, ``B02``..``B12``) or derived vegetation indices (NDVI,
    EVI, NDWI_GAO, NDRE) computed from Sentinel-2 bands on the fly.
  * Patches are all (row, col) windows of ``patch_size`` at ``stride``;
    with the reference defaults (2000px tiles, patch 256, stride 249) that
    is the dense 8x8 = 64 windows per tile.
  * ``default_clipping_transform`` clips raw bands to their physical ranges
    and ``min_max_transform`` scales them to [0, 1] — per-band constants
    below mirror the sen12tp conventions (dB backscatter clipped to
    [-30, 0] dB for VV / [-40, 0] dB for VH, reflectances to [0, 1e4],
    indices to [-1, 1] rescaled to [0, 1]).

The window index is a flat integer array; a batch of patches is
one vectorized gather from the (RAM-resident) tile stack — no per-item
Python in the hot path.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from mimo_unet_tpu.data.core import ArrayDataset, DataModule

# ---------------------------------------------------------------------------
# band conventions


@dataclasses.dataclass(frozen=True)
class Patchsize:
    """Patch window (kept as a named pair to mirror the reference CLI)."""

    width: int
    height: int


# raw physical clip ranges (default_clipping_transform)
CLIP_RANGES: Dict[str, Tuple[float, float]] = {
    "VV_sigma0": (-30.0, 0.0),
    "VH_sigma0": (-40.0, 0.0),
    # Sentinel-2 L2A reflectances (scaled by 1e4 on disk)
    **{b: (0.0, 10_000.0) for b in (
        "B02", "B03", "B04", "B05", "B06", "B07", "B08", "B8A", "B11", "B12"
    )},
    "dem": (-1000.0, 9000.0),
}

# min-max scaling ranges to [0, 1] (min_max_transform)
MINMAX_RANGES: Dict[str, Tuple[float, float]] = dict(CLIP_RANGES)

# derived vegetation indices (value range [-1, 1] -> scaled to [0, 1])
_EPS = 1e-7


def _ndvi(b):
    return (b["B08"] - b["B04"]) / (b["B08"] + b["B04"] + _EPS)


def _ndre(b):
    return (b["B08"] - b["B05"]) / (b["B08"] + b["B05"] + _EPS)


def _ndwi_gao(b):
    return (b["B08"] - b["B11"]) / (b["B08"] + b["B11"] + _EPS)


def _evi(b):
    return 2.5 * (b["B08"] - b["B04"]) / (
        b["B08"] + 6.0 * b["B04"] - 7.5 * b["B02"] + 1e4
    )


VEGETATION_INDICES: Dict[str, Callable] = {
    "NDVI": _ndvi,
    "NDRE": _ndre,
    "NDWI_GAO": _ndwi_gao,
    "EVI": _evi,
}


def default_clipping_transform(bands: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Clip raw bands to their physical ranges."""
    out = {}
    for name, arr in bands.items():
        lo, hi = CLIP_RANGES.get(name, (None, None))
        out[name] = np.clip(arr, lo, hi) if lo is not None else arr
    return out


def min_max_transform(bands: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Scale raw bands to [0, 1]; derived indices get (x + 1) / 2."""
    out = {}
    for name, arr in bands.items():
        if name in VEGETATION_INDICES:
            out[name] = (np.clip(arr, -1.0, 1.0) + 1.0) / 2.0
        elif name in MINMAX_RANGES:
            lo, hi = MINMAX_RANGES[name]
            out[name] = (np.clip(arr, lo, hi) - lo) / (hi - lo)
        else:
            out[name] = arr
    return out


# ---------------------------------------------------------------------------
# tile loading


def _load_tile(path: str) -> Dict[str, np.ndarray]:
    """Load one raster tile as {band_name: [H, W] float32}."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k].astype(np.float32) for k in z.files}
    if path.endswith(".npy"):
        arr = np.load(path)
        sidecar = os.path.join(os.path.dirname(path), "bands.json")
        with open(sidecar) as f:
            names = json.load(f)
        return {n: arr[..., i].astype(np.float32) for i, n in enumerate(names)}
    if path.endswith((".tif", ".tiff")):
        import imageio.v3 as iio

        arr = np.asarray(iio.imread(path))
        if arr.ndim == 2:
            arr = arr[..., None]
        sidecar = os.path.join(os.path.dirname(path), "bands.json")
        with open(sidecar) as f:
            names = json.load(f)
        return {n: arr[..., i].astype(np.float32) for i, n in enumerate(names)}
    raise ValueError(f"unsupported tile container: {path}")


def compute_bands(
    raw: Dict[str, np.ndarray],
    wanted: Sequence[str],
    clip_transform: Optional[Callable] = None,
    transform: Optional[Callable] = min_max_transform,
) -> Dict[str, np.ndarray]:
    """Resolve band names + derived indices, then clip/scale."""
    if clip_transform is not None:
        raw = clip_transform(raw)
    resolved: Dict[str, np.ndarray] = {}
    for name in wanted:
        if name in raw:
            resolved[name] = raw[name]
        elif name in VEGETATION_INDICES:
            resolved[name] = VEGETATION_INDICES[name](raw)
        else:
            raise KeyError(
                f"band '{name}' not in tile (has {sorted(raw)}) and not a "
                f"known index ({sorted(VEGETATION_INDICES)})"
            )
    if transform is not None:
        resolved = transform(resolved)
    return resolved


def window_positions(size: int, patch: int, stride: int) -> np.ndarray:
    """Top-left offsets of all full patch windows along one axis."""
    if size < patch:
        return np.zeros((0,), np.int64)
    return np.arange(0, size - patch + 1, stride, dtype=np.int64)


class Sen12tpDataset:
    """Patch/stride windowed view over a directory of raster tiles.

    Provides the vectorized batch access of ``ArrayDataset`` (``__getitem__``
    with an index array returns a batch dict of image/label), with patches
    gathered from the RAM-resident tile stack on demand.
    """

    def __init__(
        self,
        path: str,
        patch_size: Patchsize = Patchsize(256, 256),
        stride: int = 249,
        model_inputs: Sequence[str] = ("VV_sigma0", "VH_sigma0"),
        model_targets: Sequence[str] = ("NDVI",),
        transform: Optional[Callable] = min_max_transform,
        clip_transform: Optional[Callable] = None,
    ):
        self.patch = patch_size
        self.stride = stride
        self.model_inputs = list(model_inputs)
        self.model_targets = list(model_targets)

        files = sorted(
            os.path.join(path, f)
            for f in os.listdir(path)
            if f.endswith((".npy", ".npz", ".tif", ".tiff"))
        )
        if not files:
            raise ValueError(f"no raster tiles found under {path}")

        inputs, targets, index = [], [], []
        for tile_idx, f in enumerate(files):
            raw = _load_tile(f)
            bands = compute_bands(
                raw, self.model_inputs + self.model_targets,
                clip_transform=clip_transform, transform=transform,
            )
            img = np.stack([bands[b] for b in self.model_inputs], axis=-1)
            lbl = np.stack([bands[b] for b in self.model_targets], axis=-1)
            inputs.append(img)
            targets.append(lbl)
            h, w = img.shape[:2]
            ys = window_positions(h, self.patch.height, stride)
            xs = window_positions(w, self.patch.width, stride)
            for y in ys:
                for x in xs:
                    index.append((tile_idx, y, x))

        self.tiles_image = inputs
        self.tiles_label = targets
        # uniform tile sizes -> stacked arrays unlock the native patch gather
        shapes_i = {a.shape for a in inputs}
        if len(shapes_i) == 1:
            self._stack_image = np.ascontiguousarray(
                np.stack(inputs).astype(np.float32)
            )
            self._stack_label = np.ascontiguousarray(
                np.stack(targets).astype(np.float32)
            )
        else:
            self._stack_image = self._stack_label = None
        self.index = np.asarray(index, dtype=np.int64)
        # reference truncation hook: sen12tp_datamodule.py:33 shrinks
        # end_index by training_set_percentage
        self.end_index = len(self.index)

    def __len__(self) -> int:
        return self.end_index

    def _gather(self, rows: np.ndarray) -> Dict[str, np.ndarray]:
        ph, pw = self.patch.height, self.patch.width
        if self._stack_image is not None:
            from mimo_unet_tpu.data import _native

            t, y, x = rows[:, 0], rows[:, 1], rows[:, 2]
            img = _native.gather_patches(self._stack_image, t, y, x, ph, pw)
            lbl = _native.gather_patches(self._stack_label, t, y, x, ph, pw)
            if img is not None and lbl is not None:
                return {"image": img, "label": lbl}
            # numpy fallback on the stacked tiles (still vectorizable per-row)
            img = np.stack(
                [self._stack_image[ti, yi : yi + ph, xi : xi + pw]
                 for ti, yi, xi in rows]
            )
            lbl = np.stack(
                [self._stack_label[ti, yi : yi + ph, xi : xi + pw]
                 for ti, yi, xi in rows]
            )
            return {"image": img, "label": lbl}
        images, labels = [], []
        for tile_idx, y, x in rows:
            images.append(self.tiles_image[tile_idx][y : y + ph, x : x + pw])
            labels.append(self.tiles_label[tile_idx][y : y + ph, x : x + pw])
        return {
            "image": np.stack(images).astype(np.float32),
            "label": np.stack(labels).astype(np.float32),
        }

    def __getitem__(self, index):
        if np.isscalar(index):
            batch = self._gather(self.index[np.asarray([index])])
            return {k: v[0] for k, v in batch.items()}
        return self._gather(self.index[np.asarray(index)])


class Sen12tpDataModule(DataModule):
    """train/val/test subdirectory layout with patch windowing.

    Mirrors the external SEN12TPDataModuleV2 surface the reference uses
    (sen12tp_datamodule.py:16-35), including the ``training_set_percentage``
    truncation of the train window index.
    """

    def __init__(
        self,
        dataset_dir: str,
        batch_size: int,
        patch_size: Patchsize = Patchsize(256, 256),
        stride: int = 249,
        model_inputs: Sequence[str] = ("VV_sigma0", "VH_sigma0"),
        model_targets: Sequence[str] = ("NDVI",),
        transform: Optional[Callable] = min_max_transform,
        clip_transform: Optional[Callable] = None,
        training_set_percentage: float = 1.0,
    ):
        self.dataset_dir = dataset_dir
        self.batch_size = batch_size
        self.patch_size = patch_size
        self.stride = stride
        self.model_inputs = list(model_inputs)
        self.model_targets = list(model_targets)
        self.transform = transform
        self.clip_transform = clip_transform
        self.training_set_percentage = training_set_percentage
        self._train = self._val = self._test = None

    def _make(self, split: str) -> Optional[Sen12tpDataset]:
        path = os.path.join(self.dataset_dir, split)
        if not os.path.isdir(path):
            return None
        return Sen12tpDataset(
            path,
            patch_size=self.patch_size,
            stride=self.stride,
            model_inputs=self.model_inputs,
            model_targets=self.model_targets,
            transform=self.transform,
            clip_transform=self.clip_transform,
        )

    def setup(self) -> None:
        self._train = self._make("train")
        self._val = self._make("val")
        self._test = self._make("test")
        if self._train is not None:
            self._train.end_index = int(
                self.training_set_percentage * self._train.end_index
            )

    def train_dataset(self):
        return self._train

    def val_dataset(self):
        return self._val

    def test_dataset(self):
        return self._test

    @classmethod
    def from_args(cls, args) -> "Sen12tpDataModule":
        return cls(
            dataset_dir=args.dataset_dir,
            batch_size=args.batch_size,
            patch_size=Patchsize(args.patch_size, args.patch_size),
            stride=args.stride,
            model_inputs=args.input,
            model_targets=args.target,
            training_set_percentage=args.training_set_percentage,
        )


def get_datamodule(args) -> Sen12tpDataModule:
    """Reference-named constructor (sen12tp_datamodule.py:15-35)."""
    dm = Sen12tpDataModule.from_args(args)
    dm.setup()
    return dm


def add_datamodule_args(parent_parser):
    """Reference-identical CLI flags (sen12tp_datamodule.py:38-98)."""
    parser = parent_parser.add_argument_group(title="Sen12tpDataModule")
    parser.add_argument("--dataset_dir", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--patch_size", type=int, default=256)
    parser.add_argument("--stride", type=int, default=249)
    parser.add_argument("-i", "--input", action="append", required=True,
                        help="Set the used model inputs.")
    parser.add_argument("-t", "--target", action="append", required=True,
                        help="Specify the targets the model should predict.")
    parser.add_argument("--num_workers", type=int, default=32)
    parser.add_argument("--training_set_percentage", type=float, default=1.0)
    return parent_parser
