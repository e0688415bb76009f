"""Test configuration: run everything on a virtual 8-device CPU mesh.

Must set the XLA flags before jax initializes — hence top of conftest.
Eight virtual CPU devices stand in for a multi-device host in the
sharding tests (SURVEY.md §4: `xla_force_host_platform_device_count`).

Tests marked ``gpu`` need a CUDA device: they take the ``gpu_device``
fixture, which skips them anywhere else.  ``chip_smoke.py`` runs them
in-process on the card with ``MIMO_TESTS_ON_DEVICE=1``, which keeps this
file from forcing the CPU.
"""

import os
import sys

ON_DEVICE = os.environ.get("MIMO_TESTS_ON_DEVICE") == "1"
if not ON_DEVICE:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from mimo_unet_tpu.utils import enable_compile_cache

if not ON_DEVICE:
    jax.config.update("jax_platforms", "cpu")
# persistent compilation cache cuts repeated test-suite wall time massively
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test when JAX has none.  Decided
    here, at run time, never at import: every xdist worker must collect
    the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a CUDA device, JAX has {dev.platform}")
    return dev


REFERENCE_ROOT = "/root/reference"


def has_reference() -> bool:
    return os.path.isdir(os.path.join(REFERENCE_ROOT, "mimo"))


def import_reference():
    """Import the read-only PyTorch reference package for oracle tests.

    Only used as a numerical oracle; tests that need it are skipped when the
    reference checkout is absent (e.g. on a judge machine).
    """
    if REFERENCE_ROOT not in sys.path:
        sys.path.insert(0, REFERENCE_ROOT)
    import mimo  # noqa: F401

    return mimo


requires_reference = pytest.mark.skipif(
    not has_reference(), reason="PyTorch reference checkout not available"
)
