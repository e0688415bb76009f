"""NYUv2 depth dataset + datamodule (HDF5, NHWC).

Semantics from reference mimo/datasets/nyuv2.py:20-60 and
mimo/tasks/depth/nyuv2_datamodule.py:11-130:
  * ``depth_train.h5`` / ``depth_test.h5`` with keys ``image`` [N,H,W,3]
    and ``depth`` [N,H,W,1]; whole file loaded to RAM.
  * label = depth / 255; image / 255 when ``normalize``.
  * ``shuffle_on_load`` applies a load-time permutation; ``use_fraction``
    subsamples without replacement.
  * The reference's val split re-uses depth_train.h5 with shuffle_on_load
    (a documented quirk, nyuv2_datamodule.py:40-44) — preserved for parity.

Normalization happens once, vectorized, at load (float32 NHWC
arrays ready for zero-copy batch slicing), not per item.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from mimo_unet_tpu.data.core import ArrayDataset, DataModule


def load_nyuv2_depth(
    dataset_path: str,
    normalize: bool = True,
    shuffle_on_load: bool = False,
    use_fraction: float = 1.0,
    seed: Optional[int] = None,
    host_dtype: str = "float32",
) -> ArrayDataset:
    """``host_dtype="uint8"`` (extension, requires ``normalize``): keep
    the raw uint8 arrays on the host; the /255 runs on-device inside the
    jitted step (data/core.py device_normalize).  4x less host RAM, host
    copy and H2D transfer than float32."""
    import h5py

    with h5py.File(dataset_path, "r") as h5:
        image = np.array(h5["image"])
        label = np.array(h5["depth"])

    rng = np.random.default_rng(seed)
    perm = (
        rng.permutation(len(image)) if shuffle_on_load else np.arange(len(image))
    )
    if use_fraction < 1.0:
        perm = rng.choice(perm, size=int(len(image) * use_fraction), replace=False)
    image, label = image[perm], label[perm]

    if host_dtype == "uint8":
        if not normalize:
            raise ValueError("host_dtype='uint8' implies normalize=True")
        # The h5 must hold byte-range integer data for the uint8 staging
        # to be lossless (the NYUv2 archives do: uint8 image/depth).  A
        # float or wide-integer source would be silently truncated/wrapped
        # by .astype(np.uint8), quantizing labels vs the float32 path.
        for name, arr in (("image", image), ("depth", label)):
            if not np.issubdtype(arr.dtype, np.integer):
                raise ValueError(
                    f"host_dtype='uint8' requires integer {name} data in "
                    f"the h5, got {arr.dtype}; use host_dtype='float32'"
                )
            if arr.dtype != np.uint8 and (arr.min() < 0 or arr.max() > 255):
                raise ValueError(
                    f"host_dtype='uint8': {name} values outside [0, 255] "
                    f"({arr.dtype}); use host_dtype='float32'"
                )
        image = image.astype(np.uint8)
        label_u8 = label.astype(np.uint8)
        if label_u8.ndim == 3:
            label_u8 = label_u8[..., None]
        return ArrayDataset({"image": image, "label": label_u8})

    image = image.astype(np.float32)
    if normalize:
        image /= 255.0
    label = label.astype(np.float32) / 255.0
    if label.ndim == 3:
        label = label[..., None]
    return ArrayDataset({"image": image, "label": label})


class NYUv2DepthDataModule(DataModule):
    def __init__(
        self,
        dataset_dir: str,
        batch_size: int,
        normalize: bool = True,
        train_dataset_fraction: float = 1.0,
        seed: Optional[int] = None,
        host_dtype: str = "float32",
    ):
        self.dataset_dir = dataset_dir
        self.batch_size = batch_size
        self.normalize = normalize
        self.train_dataset_fraction = train_dataset_fraction
        self.seed = seed
        self.host_dtype = host_dtype
        self._train = self._val = self._test = None

    def setup(self) -> None:
        train_path = os.path.join(self.dataset_dir, "depth_train.h5")
        test_path = os.path.join(self.dataset_dir, "depth_test.h5")
        self._train = load_nyuv2_depth(
            train_path,
            normalize=self.normalize,
            shuffle_on_load=False,
            use_fraction=self.train_dataset_fraction,
            seed=self.seed,
            host_dtype=self.host_dtype,
        )
        # reference quirk preserved: val split re-reads the training file
        self._val = load_nyuv2_depth(
            train_path, normalize=self.normalize, shuffle_on_load=True, seed=self.seed
        )
        if os.path.exists(test_path):
            self._test = load_nyuv2_depth(
                test_path, normalize=self.normalize, shuffle_on_load=True, seed=self.seed
            )

    def train_dataset(self) -> ArrayDataset:
        return self._train

    def val_dataset(self) -> Optional[ArrayDataset]:
        return self._val

    def test_dataset(self) -> Optional[ArrayDataset]:
        return self._test

    @classmethod
    def from_args(cls, args) -> "NYUv2DepthDataModule":
        return cls(
            dataset_dir=args.dataset_dir,
            batch_size=args.batch_size,
            train_dataset_fraction=args.train_dataset_fraction,
            seed=getattr(args, "seed", None),
            host_dtype=getattr(args, "host_dtype", "float32"),
        )

    @staticmethod
    def add_model_specific_args(parent_parser):
        """Reference-identical flags (nyuv2_datamodule.py:93-130);
        num_workers/pin_memory accepted for CLI compatibility, unused."""
        parser = parent_parser.add_argument_group(title="NYUv2DepthDataModule")
        parser.add_argument("--dataset_dir", type=str, required=True)
        parser.add_argument("--batch_size", type=int, default=32)
        parser.add_argument("--num_workers", type=int, default=32)
        parser.add_argument("--pin_memory", type=bool, default=True)
        parser.add_argument("--train_dataset_fraction", type=float, default=1.0)
        parser.add_argument(
            "--host_dtype", type=str, default="float32",
            choices=["float32", "uint8"],
            help="Extension: uint8 keeps raw bytes on the host and "
                 "normalizes on-device (4x less host work and transfer)")
        return parent_parser
