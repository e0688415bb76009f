"""mimo_unet_tpu — a probabilistic MIMO U-Net framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of the PyTorch
reference implementation of "Probabilistic MIMO U-Net: Efficient and Accurate
Uncertainty Estimation for Pixel-wise Regression" (ICCV 2023 UnCV workshop).

Design stance (not a line-by-line translation):
  * NHWC tensor layout everywhere; the MIMO subnetwork axis ``S`` is a
    ``jax.vmap``-batched parameter axis, not a Python loop over modules.
  * Single fused XLA program per train/eval step; all state (params, batch
    norm statistics, optimizer moments, the loss-buffer ring, PRNG keys) is
    carried through pure functions so the step is one ``jit``.
  * Data parallelism via ``jax.sharding`` over a device mesh: the batch axis
    is sharded, parameters replicated, and XLA inserts the collectives.
  * No hand-written kernels: convolutions go to XLA (cuDNN on the GPU) and
    XLA fuses BatchNorm, ReLU and the loss around them.

Reference parity map (reference = antonbaumann/MIMO-Unet):
  losses           <-> mimo/losses.py
  loss_buffer      <-> mimo/models/mimo_components/loss_buffer.py
  transforms       <-> mimo/models/utils.py
  models.blocks    <-> mimo/models/mimo_components/components.py
  models.mimo_unet <-> mimo/models/mimo_components/model.py
  tasks.mimo       <-> mimo/models/mimo_unet.py
  tasks.evidential <-> mimo/models/evidential_unet.py
  models.ensemble  <-> mimo/models/ensemble.py
  metrics          <-> mimo/metrics.py
  data.*           <-> mimo/datasets/*, mimo/tasks/*/*_datamodule.py
"""

__version__ = "0.1.0"

# Public surface re-exports (import is cheap; heavy deps load lazily inside)
from mimo_unet_tpu.losses import (  # noqa: E402
    EvidentialLoss,
    GaussianNLL,
    LaplaceNLL,
    UncertaintyLoss,
)
from mimo_unet_tpu.metrics import compute_regression_metrics  # noqa: E402
from mimo_unet_tpu.models import (  # noqa: E402
    MimoUNetConfig,
    count_parameters,
    mimo_unet_apply,
    mimo_unet_init,
)
from mimo_unet_tpu.transforms import (  # noqa: E402
    apply_input_transform,
    compute_uncertainties,
    flatten_subnetwork_dimension,
    repeat_subnetworks,
)

__all__ = [
    "UncertaintyLoss", "GaussianNLL", "LaplaceNLL", "EvidentialLoss",
    "compute_regression_metrics",
    "MimoUNetConfig", "mimo_unet_init", "mimo_unet_apply", "count_parameters",
    "apply_input_transform", "repeat_subnetworks",
    "flatten_subnetwork_dimension", "compute_uncertainties",
]
