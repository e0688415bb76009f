"""Dataset/datamodule tests on synthetic fixtures."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from make_fixtures import make_make3d, make_muad, make_nyuv2_h5, make_sen12tp_tiles

from mimo_unet_tpu.data.core import ArrayDataset, iterate_batches, prefetch_to_device
from mimo_unet_tpu.data.nyuv2 import NYUv2DepthDataModule, load_nyuv2_depth
from mimo_unet_tpu.data.sen12tp import (
    Patchsize,
    Sen12tpDataModule,
    Sen12tpDataset,
    compute_bands,
    min_max_transform,
    default_clipping_transform,
    window_positions,
)


class TestCore:
    def test_array_dataset_batch_slicing(self, rng):
        ds = ArrayDataset({"a": np.arange(10), "b": np.arange(10) * 2})
        batch = ds[np.array([1, 3])]
        np.testing.assert_array_equal(batch["a"], [1, 3])
        np.testing.assert_array_equal(batch["b"], [2, 6])
        with pytest.raises(ValueError):
            ArrayDataset({"a": np.arange(3), "b": np.arange(4)})

    def test_iterate_batches(self):
        ds = ArrayDataset({"x": np.arange(10)})
        batches = list(iterate_batches(ds, 4, drop_last=True))
        assert [len(b["x"]) for b in batches] == [4, 4]
        batches = list(iterate_batches(ds, 4, drop_last=False))
        assert [len(b["x"]) for b in batches] == [4, 4, 2]
        # shuffling covers everything exactly once and reseeds per epoch
        b0 = np.concatenate(
            [b["x"] for b in iterate_batches(ds, 4, shuffle=True, seed=1, epoch=0)]
        )
        b1 = np.concatenate(
            [b["x"] for b in iterate_batches(ds, 4, shuffle=True, seed=1, epoch=1)]
        )
        np.testing.assert_array_equal(np.sort(b0), np.arange(10))
        assert not np.array_equal(b0, b1)

    def test_prefetch(self):
        ds = ArrayDataset({"x": np.arange(12, dtype=np.float32)})
        got = list(prefetch_to_device(iterate_batches(ds, 4)))
        assert len(got) == 3
        np.testing.assert_array_equal(np.asarray(got[0]["x"]), [0, 1, 2, 3])

    def test_prefetch_chunked_matches_per_step(self):
        """chunk>1 uploads several batches per device_put and yields
        on-device slices; the yielded stream must be identical to the
        chunk=1 stream, including a ragged final batch (drop_last off)."""
        ds = ArrayDataset({"x": np.arange(14, dtype=np.float32),
                           "y": np.arange(14, dtype=np.float32) * 2})
        ref = list(prefetch_to_device(
            iterate_batches(ds, 4, drop_last=False)))
        got = list(prefetch_to_device(
            iterate_batches(ds, 4, drop_last=False), chunk=3))
        assert len(got) == len(ref) == 4
        for r, g in zip(ref, got):
            assert set(g) == set(r)
            for k in r:
                np.testing.assert_array_equal(np.asarray(g[k]),
                                              np.asarray(r[k]))

    def test_prefetch_propagates_errors(self):
        def bad():
            yield {"x": np.zeros(2)}
            raise RuntimeError("boom")

        it = prefetch_to_device(bad())
        next(it)
        with pytest.raises(RuntimeError, match="boom"):
            next(it)

    def test_device_dataset_gather_matches_host_indexing(self):
        from mimo_unet_tpu.data.core import DeviceDataset

        rng = np.random.default_rng(0)
        ds = ArrayDataset({
            "image": rng.integers(0, 256, (10, 4, 4, 3)).astype(np.uint8),
            "label": rng.random((10, 4, 4, 1)).astype(np.float32),
        })
        dev = DeviceDataset(ds)
        assert len(dev) == 10
        assert dev.nbytes == ds.data["image"].nbytes + ds.data["label"].nbytes
        idx = np.array([3, 1, 7, 3])
        got = jax.jit(dev.gather)(idx)
        host = ds[idx]
        for k in ("image", "label"):
            assert np.asarray(got[k]).dtype == host[k].dtype
            np.testing.assert_array_equal(np.asarray(got[k]), host[k])

    def test_index_batches_match_batch_iteration_order(self):
        from mimo_unet_tpu.data.core import iterate_index_batches

        ds = ArrayDataset({"x": np.arange(10, dtype=np.float32)})
        via_batches = [b["x"] for b in iterate_batches(
            ds, 4, shuffle=True, drop_last=True, seed=3, epoch=2)]
        via_idx = [ds[i]["x"] for i in iterate_index_batches(
            10, 4, shuffle=True, drop_last=True, seed=3, epoch=2)]
        assert len(via_batches) == len(via_idx) == 2
        for a, b in zip(via_batches, via_idx):
            np.testing.assert_array_equal(a, b)


class TestDeviceCacheBudget:
    class _Dev:
        def __init__(self, platform, stats):
            self.platform, self.device_kind, self._stats = platform, "x", stats

        def memory_stats(self):
            return self._stats

    @pytest.mark.parametrize("platform,stats,want", [
        ("cpu", None, None),  # no limit on the host: no gate
        ("gpu", {"bytes_limit": 1000, "bytes_in_use": 200}, 480),
        ("gpu", None, RuntimeError),  # an accelerator without stats
    ])
    def test_budget_from_memory_stats(self, monkeypatch, platform, stats,
                                      want):
        from mimo_unet_tpu.data import core

        monkeypatch.setattr(core.jax, "local_devices",
                            lambda: [self._Dev(platform, stats)])
        if want is RuntimeError:
            with pytest.raises(RuntimeError, match="no memory limit"):
                core.device_cache_budget_bytes()
        else:
            assert core.device_cache_budget_bytes() == want


class TestNYUv2:
    def test_load_semantics(self, tmp_path):
        path = make_nyuv2_h5(str(tmp_path), n=10, h=16, w=16)
        ds = load_nyuv2_depth(os.path.join(path, "depth_train.h5"))
        assert len(ds) == 10
        b = ds[np.arange(2)]
        assert b["image"].shape == (2, 16, 16, 3)
        assert b["label"].shape == (2, 16, 16, 1)
        assert b["image"].max() <= 1.0 and b["label"].max() <= 1.0

        ds_frac = load_nyuv2_depth(
            os.path.join(path, "depth_train.h5"), use_fraction=0.5, seed=0
        )
        assert len(ds_frac) == 5

        raw = load_nyuv2_depth(os.path.join(path, "depth_train.h5"), normalize=False)
        assert raw[np.arange(1)]["image"].max() > 1.0

    def test_uint8_staging_matches_float32_pipeline(self, tmp_path):
        """host_dtype='uint8' + on-device /255 must be bitwise-identical to
        the float32 host pipeline (both are exact: uint8/255 in f32)."""
        from mimo_unet_tpu.data.core import device_normalize

        path = make_nyuv2_h5(str(tmp_path), n=6, h=16, w=16)
        f32 = load_nyuv2_depth(os.path.join(path, "depth_train.h5"))
        u8 = load_nyuv2_depth(
            os.path.join(path, "depth_train.h5"), host_dtype="uint8"
        )
        idx = np.arange(4)
        b8 = u8[idx]
        assert b8["image"].dtype == np.uint8 and b8["label"].dtype == np.uint8
        normed = device_normalize({k: jnp.asarray(v) for k, v in b8.items()})
        ref = f32[idx]
        for k in ("image", "label"):
            np.testing.assert_array_equal(np.asarray(normed[k]), ref[k])

    def test_device_normalize_keeps_mask_semantics(self):
        """uint8 0/1 masks and validity rows must convert dtype only —
        rescaling them by /255 would zero out every valid pixel."""
        from mimo_unet_tpu.data.core import device_normalize

        batch = {
            "image": jnp.full((2, 4, 4, 3), 255, jnp.uint8),
            "mask": jnp.ones((2, 4, 4, 1), jnp.uint8),
            "valid": jnp.ones((2,), jnp.uint8),
        }
        out = device_normalize(batch)
        assert float(out["image"].max()) == 1.0
        np.testing.assert_array_equal(np.asarray(out["mask"]), 1.0)
        np.testing.assert_array_equal(np.asarray(out["valid"]), 1.0)

    def test_uint8_staging_rejects_lossy_sources(self, tmp_path):
        """Float or wide-integer h5 data must be refused, not silently
        truncated (ADVICE r2: .astype(np.uint8) wraps/quantizes)."""
        import h5py

        fp = os.path.join(str(tmp_path), "depth_train.h5")
        with h5py.File(fp, "w") as f:
            f.create_dataset(
                "image", data=np.random.rand(2, 8, 8, 3).astype(np.float32)
            )
            f.create_dataset(
                "depth", data=np.random.rand(2, 8, 8, 1).astype(np.float32)
            )
        with pytest.raises(ValueError, match="integer"):
            load_nyuv2_depth(fp, host_dtype="uint8")

        with h5py.File(fp, "w") as f:
            f.create_dataset(
                "image",
                data=np.random.randint(0, 1000, (2, 8, 8, 3)).astype(np.uint16),
            )
            f.create_dataset(
                "depth", data=np.random.randint(0, 255, (2, 8, 8, 1), dtype=np.uint8)
            )
        with pytest.raises(ValueError, match=r"\[0, 255\]"):
            load_nyuv2_depth(fp, host_dtype="uint8")

    def test_datamodule(self, tmp_path):
        path = make_nyuv2_h5(str(tmp_path), n=10, h=16, w=16)
        dm = NYUv2DepthDataModule(dataset_dir=path, batch_size=4, seed=0)
        dm.setup()
        assert len(dm.train_dataset()) == 10
        assert len(dm.val_dataset()) == 10  # reference quirk: same file
        assert len(dm.test_dataset()) == 5
        train_batches = list(dm.train_batches(epoch=0))
        assert len(train_batches) == 2  # drop_last


class TestSen12tp:
    def test_window_positions(self):
        np.testing.assert_array_equal(
            window_positions(2000, 256, 249), np.arange(8) * 249
        )
        assert len(window_positions(100, 256, 249)) == 0

    def test_dataset_windowing(self, tmp_path):
        path = make_sen12tp_tiles(str(tmp_path), n_tiles=2, size=200)
        ds = Sen12tpDataset(
            os.path.join(path, "train"),
            patch_size=Patchsize(64, 64),
            stride=60,
            model_inputs=["VV_sigma0", "VH_sigma0"],
            model_targets=["NDVI"],
        )
        # (200-64)//60+1 = 3 positions per axis, 9 windows per tile, 2 tiles
        assert len(ds) == 18
        b = ds[np.arange(3)]
        assert b["image"].shape == (3, 64, 64, 2)
        assert b["label"].shape == (3, 64, 64, 1)
        assert 0.0 <= b["image"].min() and b["image"].max() <= 1.0
        assert 0.0 <= b["label"].min() and b["label"].max() <= 1.0

    def test_ndvi_computation(self):
        raw = {
            "B08": np.array([[5000.0]], np.float32),
            "B04": np.array([[1000.0]], np.float32),
        }
        bands = compute_bands(raw, ["NDVI"], transform=None)
        np.testing.assert_allclose(bands["NDVI"], (5000 - 1000) / (5000 + 1000),
                                   rtol=1e-5)
        scaled = compute_bands(raw, ["NDVI"], transform=min_max_transform)
        np.testing.assert_allclose(
            scaled["NDVI"], (bands["NDVI"] + 1) / 2, rtol=1e-6
        )

    def test_unknown_band_raises(self):
        with pytest.raises(KeyError, match="not in tile"):
            compute_bands({"B04": np.zeros((2, 2))}, ["B99"])

    def test_clipping_transform(self):
        raw = {"VV_sigma0": np.array([-50.0, 5.0], np.float32)}
        clipped = default_clipping_transform(raw)
        np.testing.assert_array_equal(clipped["VV_sigma0"], [-30.0, 0.0])

    def test_datamodule_truncation(self, tmp_path):
        path = make_sen12tp_tiles(str(tmp_path), n_tiles=2, size=200)
        dm = Sen12tpDataModule(
            dataset_dir=path, batch_size=4, patch_size=Patchsize(64, 64),
            stride=60, model_inputs=["VV_sigma0", "VH_sigma0"],
            model_targets=["NDVI"], training_set_percentage=0.5,
        )
        dm.setup()
        assert len(dm.train_dataset()) == 9  # truncated from 18
        assert len(dm.val_dataset()) == 18

    def test_from_args_cli_contract(self, tmp_path):
        from argparse import ArgumentParser
        from mimo_unet_tpu.data.sen12tp import add_datamodule_args, get_datamodule

        path = make_sen12tp_tiles(str(tmp_path), n_tiles=1, size=128)
        parser = ArgumentParser()
        parser = add_datamodule_args(parser)
        args = parser.parse_args(
            [
                "--dataset_dir", path, "--batch_size", "2", "--patch_size", "64",
                "--stride", "64", "-i", "VV_sigma0", "-i", "VH_sigma0",
                "-t", "NDVI",
            ]
        )
        dm = get_datamodule(args)
        assert dm.model_inputs == ["VV_sigma0", "VH_sigma0"]
        assert dm.model_targets == ["NDVI"]
        assert len(dm.train_dataset()) == 4  # 2x2 windows of 64 in 128


class TestMake3d:
    def test_load(self, tmp_path):
        from mimo_unet_tpu.data.make3d import load_make3d_depth

        path = make_make3d(str(tmp_path), n=3)
        ds = load_make3d_depth(os.path.join(path, "train"))
        assert len(ds) == 3
        b = ds[np.arange(2)]
        assert b["image"].shape == (2, 460, 345, 3)
        assert b["label"].shape == (2, 460, 345, 1)
        assert b["mask"].shape == (2, 460, 345, 1)
        assert b["image"].max() <= 1.0
        # mask marks depth <= 70 (pre-normalization meters)
        recovered_depth = b["label"] * 120.0
        assert ((recovered_depth <= 70 + 1e-3) == (b["mask"] > 0.5)).mean() > 0.99

    def test_without_mask_matches_reference_contract(self, tmp_path):
        from mimo_unet_tpu.data.make3d import load_make3d_depth

        path = make_make3d(str(tmp_path), n=2)
        ds = load_make3d_depth(os.path.join(path, "train"), with_mask=False)
        assert set(ds.keys) == {"image", "label"}


class TestMake3dDataModule:
    def test_setup_and_batches(self, tmp_path):
        from mimo_unet_tpu.data.make3d import Make3dDepthDataModule

        path = make_make3d(str(tmp_path), n=4, splits=("train", "test"))
        dm = Make3dDepthDataModule(dataset_dir=path, batch_size=2, seed=0)
        dm.setup()
        assert len(dm.train_dataset()) == 4
        assert len(dm.test_dataset()) == 4
        batches = list(dm.train_batches(epoch=0))
        assert len(batches) == 2
        assert set(batches[0]) == {"image", "label", "mask"}


class TestMUADDataModule:
    def test_setup(self, tmp_path):
        from mimo_unet_tpu.data.muad import MUADDepthDataModule

        path = make_muad(str(tmp_path), n=4, size=24, splits=("train",))
        dm = MUADDepthDataModule(dataset_dir=path, batch_size=2, seed=0)
        dm.setup()
        assert len(dm.train_dataset()) == 4
        # no val/ dir -> val falls back to shuffled train
        assert len(dm.val_dataset()) == 4
        assert dm.test_dataset() is None


class TestMUAD:
    def test_load_depth(self, tmp_path):
        import cv2

        from mimo_unet_tpu.data.muad import load_muad_depth

        path = make_muad(str(tmp_path), n=3, size=24)
        try:
            ds = load_muad_depth(os.path.join(path, "train"))
        except Exception as e:
            if "exr" in str(e).lower():
                pytest.skip(f"cv2 EXR support unavailable: {e}")
            raise
        assert len(ds) == 3
        b = ds[np.arange(3)]
        assert b["image"].shape == (3, 24, 24, 3)
        assert b["label"].shape == (3, 24, 24, 1)
        assert b["mask"].shape == (3, 24, 24, 1)
        # depth = 1 - disparity, all finite -> mask all ones
        np.testing.assert_array_equal(b["mask"], 1.0)

    def test_missing_dir_message(self, tmp_path):
        from mimo_unet_tpu.data.muad import load_muad_depth

        with pytest.raises(ValueError, match="not a directory"):
            load_muad_depth(os.path.join(str(tmp_path), "nope"))
