from mimo_unet_tpu.data.core import (
    ArrayDataModule,
    ArrayDataset,
    DataModule,
    iterate_batches,
    prefetch_to_device,
)

__all__ = ["ArrayDataModule", "ArrayDataset", "DataModule", "iterate_batches", "prefetch_to_device"]
