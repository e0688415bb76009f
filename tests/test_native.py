"""Native C++ gather kernels vs numpy oracles."""

import os

import numpy as np
import pytest

from mimo_unet_tpu.data import _native


@pytest.fixture(scope="module")
def lib_available():
    if not _native.available():
        pytest.skip("native gather library unavailable (no g++?)")
    return True


class TestGatherRows:
    def test_matches_numpy(self, lib_available, rng):
        src = rng.standard_normal((100, 17, 9, 3)).astype(np.float32)
        idx = rng.integers(0, 100, size=37)
        got = _native.gather_rows(src, idx, num_threads=2)
        np.testing.assert_array_equal(got, src[idx])

    def test_dtypes(self, lib_available, rng):
        for dtype in (np.uint8, np.float64, np.int32):
            src = (rng.standard_normal((20, 5)) * 10).astype(dtype)
            idx = rng.integers(0, 20, size=8)
            got = _native.gather_rows(src, idx, num_threads=2)
            np.testing.assert_array_equal(got, src[idx])

    def test_non_contiguous_falls_back(self, lib_available, rng):
        src = rng.standard_normal((10, 6)).astype(np.float32)[:, ::2]
        assert _native.gather_rows(src, np.arange(3), num_threads=2) is None

    def test_single_thread_path(self, lib_available, rng):
        src = rng.standard_normal((10, 4)).astype(np.float32)
        idx = np.array([3, 1, 4])
        # single-threaded gather_rows declines (numpy is at parity there)
        assert _native.gather_rows(src, idx, num_threads=1) is None


class TestGatherPatches:
    def test_matches_numpy(self, lib_available, rng):
        tiles = rng.standard_normal((3, 40, 50, 2)).astype(np.float32)
        n = 25
        t = rng.integers(0, 3, size=n)
        ys = rng.integers(0, 40 - 16 + 1, size=n)
        xs = rng.integers(0, 50 - 16 + 1, size=n)
        got = _native.gather_patches(tiles, t, ys, xs, 16, 16)
        want = np.stack(
            [tiles[ti, yi : yi + 16, xi : xi + 16] for ti, yi, xi in zip(t, ys, xs)]
        )
        np.testing.assert_array_equal(got, want)


class TestDatasetIntegration:
    def test_array_dataset_uses_native(self, rng):
        from mimo_unet_tpu.data.core import ArrayDataset

        ds = ArrayDataset({"x": rng.standard_normal((50, 8, 8, 3)).astype(np.float32)})
        idx = rng.integers(0, 50, size=16)
        np.testing.assert_array_equal(ds[idx]["x"], ds.data["x"][idx])

    def test_sen12tp_native_gather(self, tmp_path, rng):
        from make_fixtures import make_sen12tp_tiles
        from mimo_unet_tpu.data.sen12tp import Patchsize, Sen12tpDataset
        import os

        path = make_sen12tp_tiles(str(tmp_path), n_tiles=2, size=128)
        ds = Sen12tpDataset(
            os.path.join(path, "train"), patch_size=Patchsize(64, 64), stride=32,
        )
        idx = np.arange(len(ds))
        batch = ds[idx]
        # oracle: direct slicing from the per-tile lists
        ph = pw = 64
        want = np.stack(
            [
                ds.tiles_image[t][y : y + ph, x : x + pw]
                for t, y, x in ds.index[idx]
            ]
        ).astype(np.float32)
        np.testing.assert_allclose(batch["image"], want, rtol=1e-6)


def test_library_keyed_on_source_hash(tmp_path, monkeypatch):
    """Only a build of this very gather.cc is loaded: the library name
    carries the source hash, so an edited source gets a new file."""
    path = _native._lib_path()
    assert path.startswith(os.path.join(os.path.dirname(_native.__file__),
                                        "build", "libmimo_gather-"))
    src = tmp_path / "gather.cc"
    src.write_bytes(open(_native._SRC, "rb").read() + b"\n// edited\n")
    monkeypatch.setattr(_native, "_SRC", str(src))
    assert _native._lib_path() != path
