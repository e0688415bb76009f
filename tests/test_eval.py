"""Ensemble, FGSM, and artifact pipeline tests (CPU)."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mimo_unet_tpu.data.core import ArrayDataset
from mimo_unet_tpu.eval.artifacts import (
    create_calibration,
    create_precision_recall,
    convert_to_dataframe,
    make_predictions,
    make_predictions_evidential,
    write_artifacts,
)
from mimo_unet_tpu.eval.fgsm import fgsm_attack
from mimo_unet_tpu.models.ensemble import Ensemble
from mimo_unet_tpu.tasks import EvidentialUnetTask, MimoUnetTask
from mimo_unet_tpu.train.checkpoint import save_checkpoint


@pytest.fixture(scope="module")
def trained_ckpts(tmp_path_factory):
    """Two tiny trained checkpoints (one with dropout for MC testing)."""
    root = tmp_path_factory.mktemp("ckpts")
    rng = np.random.default_rng(0)
    image = rng.uniform(size=(8, 32, 32, 3)).astype(np.float32)
    label = image.mean(axis=-1, keepdims=True)
    batch = {"image": jnp.asarray(image), "label": jnp.asarray(label)}

    paths = []
    for i, dropout in enumerate((0.0, 0.2)):
        task = MimoUnetTask(
            in_channels=3, out_channels=2, num_subnetworks=2,
            filter_base_count=4, loss="laplace_nll", seed=i,
            center_dropout_rate=dropout, final_dropout_rate=dropout,
        )
        tx = task.make_optimizer(2)
        state = task.init_state(2)
        for _ in range(3):
            state, _, _ = task.train_step(tx, state, batch, jax.random.key(i))
        path = os.path.join(root, f"m{i}")
        save_checkpoint(path, state, task.hparams())
        paths.append(path)
    return paths


@pytest.fixture(scope="module")
def tiny_dataset():
    rng = np.random.default_rng(1)
    image = rng.uniform(size=(7, 32, 32, 3)).astype(np.float32)
    label = image.mean(axis=-1, keepdims=True)
    return ArrayDataset({"image": image, "label": label})


class TestEnsemble:
    def test_multi_checkpoint_concat(self, trained_ckpts):
        ens = Ensemble(trained_ckpts, return_raw_predictions=True)
        assert ens.num_subnetworks == 4
        x = jnp.ones((2, 32, 32, 3))
        p1, p2 = ens(x)
        assert p1.shape == (2, 4, 32, 32, 1)
        assert p2.shape == (2, 4, 32, 32, 1)

    @pytest.mark.parametrize("mc", [0, 2])
    def test_stacked_members_match_member_runs(self, trained_ckpts, mc):
        """Same-architecture members run as one vmapped program over
        stacked parameters; each member's slice of the output equals that
        member run alone (members x MC passes, member-major)."""
        ens = Ensemble(trained_ckpts[1:] * 2, monte_carlo_steps=mc,
                       return_raw_predictions=True)
        assert len(ens._runs) == 1
        x = jax.random.uniform(jax.random.key(3), (2, 32, 32, 3))
        p1, p2 = ens(x, rng=jax.random.key(0))
        width = 2 * max(1, mc)
        assert p1.shape == (2, 2 * width, 32, 32, 1)
        if mc == 0:  # deterministic: both members give the lone one's output
            s1, s2 = Ensemble(trained_ckpts[1:],
                              return_raw_predictions=True)(x)
            for half in (slice(0, width), slice(width, 2 * width)):
                np.testing.assert_allclose(np.asarray(p1[:, half]),
                                           np.asarray(s1), rtol=1e-5,
                                           atol=1e-6)
                np.testing.assert_allclose(np.asarray(p2[:, half]),
                                           np.asarray(s2), rtol=1e-5,
                                           atol=1e-6)
        else:  # MC: each member draws its own dropout masks
            assert not np.allclose(np.asarray(p1[:, :width]),
                                   np.asarray(p1[:, width:]))

    def test_uncertainty_mode(self, trained_ckpts):
        ens = Ensemble(trained_ckpts[:1])
        x = jnp.ones((2, 32, 32, 3))
        mean, ale, epi = ens(x)
        assert mean.shape == (2, 32, 32, 1)
        assert float(jnp.min(ale)) > 0

    def test_mc_dropout_stochastic(self, trained_ckpts):
        # second checkpoint has dropout; mc_steps widens the S axis
        ens = Ensemble([trained_ckpts[1]], monte_carlo_steps=3,
                       return_raw_predictions=True)
        assert ens.output_width == 6
        x = jnp.ones((2, 32, 32, 3))
        p1, _ = ens(x, rng=jax.random.key(0))
        assert p1.shape[1] == 6
        # different MC passes give different predictions (dropout live)
        assert not np.allclose(np.asarray(p1[:, 0]), np.asarray(p1[:, 2]))

    def test_predict_batched_with_padding(self, trained_ckpts, rng):
        ens = Ensemble(trained_ckpts[:1])
        images = rng.uniform(size=(7, 32, 32, 3)).astype(np.float32)
        mean, ale, epi = ens.predict(images, batch_size=4)
        assert mean.shape == (7, 32, 32, 1)
        # padded-batch results equal an unbatched run
        m2, a2, e2 = ens(jnp.asarray(images))
        np.testing.assert_allclose(mean, np.asarray(m2), atol=1e-6)
        np.testing.assert_allclose(ale, np.asarray(a2), atol=1e-6)

    def test_mismatched_loss_rejected(self, tmp_path, trained_ckpts):
        task = MimoUnetTask(
            in_channels=3, out_channels=2, num_subnetworks=1,
            filter_base_count=4, loss="gaussian_nll", seed=9,
        )
        state = task.init_state(1)
        path = os.path.join(tmp_path, "gauss")
        save_checkpoint(path, state, task.hparams())
        with pytest.raises(ValueError, match="loss"):
            Ensemble([trained_ckpts[0], path])


class TestFGSM:
    def test_attack_clips_and_perturbs(self):
        x = jnp.full((2, 4, 4, 3), 0.5)
        g = jnp.ones_like(x)
        out = np.asarray(fgsm_attack(x, 0.1, g))
        np.testing.assert_allclose(out, 0.6, rtol=1e-6)
        out = np.asarray(fgsm_attack(jnp.full_like(x, 0.95), 0.1, g))
        np.testing.assert_allclose(out, 1.0)

    def test_epsilon_increases_nll(self, trained_ckpts, tiny_dataset):
        """FGSM maximizes the ensemble NLL to first order — check the NLL on
        the perturbed input exceeds the clean NLL (the quantity the attack
        ascends), and that inputs actually moved but stayed in [0, 1]."""
        from mimo_unet_tpu.transforms import repeat_subnetworks

        ens = Ensemble(trained_ckpts[:1], return_raw_predictions=True)
        idx = np.arange(4)
        batch = tiny_dataset[idx]
        image = jnp.asarray(batch["image"])
        label_rep = repeat_subnetworks(jnp.asarray(batch["label"]), ens.output_width)

        from mimo_unet_tpu.eval.fgsm import make_fgsm_fn

        rng = jax.random.key(0)
        x_clean, p1c, p2c = make_fgsm_fn(ens, 0.0)(image, jnp.asarray(batch["label"]), rng)
        x_adv, p1a, p2a = make_fgsm_fn(ens, 0.04)(image, jnp.asarray(batch["label"]), rng)
        nll_clean = float(ens.loss_fn(p1c, p2c, label_rep))
        nll_adv = float(ens.loss_fn(p1a, p2a, label_rep))
        assert nll_adv > nll_clean, (nll_clean, nll_adv)
        assert not np.allclose(np.asarray(x_clean), np.asarray(x_adv))
        assert float(x_adv.min()) >= 0 and float(x_adv.max()) <= 1

    def test_fgsm_through_stacked_ensemble(self, trained_ckpts):
        """Differentiating through eval: two copies of one checkpoint run
        as one stacked (vmapped) program, and their ensemble NLL is the
        single member's, so the attack and the predictions must equal the
        single-member ones."""
        from mimo_unet_tpu.eval.fgsm import make_fgsm_fn

        image = jax.random.uniform(jax.random.key(1), (2, 32, 32, 3))
        label = jax.random.uniform(jax.random.key(2), (2, 32, 32, 1))
        rng = jax.random.key(0)
        one = Ensemble(trained_ckpts[:1], return_raw_predictions=True)
        two = Ensemble([trained_ckpts[0]] * 2, return_raw_predictions=True)
        x1, p1, _ = make_fgsm_fn(one, 0.02)(image, label, rng)
        x2, p2, _ = make_fgsm_fn(two, 0.02)(image, label, rng)
        np.testing.assert_array_equal(np.asarray(x1), np.asarray(x2))
        np.testing.assert_allclose(np.asarray(p2[:, :2]), np.asarray(p1),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(p2[:, 2:]), np.asarray(p1),
                                   rtol=1e-5, atol=1e-6)


class TestArtifacts:
    def test_shapes_and_files(self, trained_ckpts, tiny_dataset, tmp_path):
        ens = Ensemble(trained_ckpts, return_raw_predictions=True)
        preds = make_predictions(ens, tiny_dataset, batch_size=4, epsilon=0.0)
        inputs, y_pred, y_true, ale, epi, comb = preds
        assert inputs.shape == (7, 32, 32, 3)
        assert y_pred.shape == (7, 32, 32)
        np.testing.assert_allclose(comb, ale + epi, rtol=1e-6)

        paths = write_artifacts(str(tmp_path), "test", 0.0, preds)
        for suffix in (
            "inputs.npy", "y_preds.npy", "y_trues.npy", "aleatoric_vars.npy",
            "epistemic_vars.npy", "metrics.pkl", "precision_recall.csv",
            "calibration.csv",
        ):
            assert os.path.exists(paths[suffix]), suffix

        import pandas as pd

        df = pd.read_pickle(paths["metrics.pkl"])
        assert list(df.columns) == [
            "y_pred", "y_true", "aleatoric_std", "epistemic_std",
            "combined_std", "error",
        ]
        pr = pd.read_csv(paths["precision_recall.csv"])
        assert list(pr.columns) == ["percentile", "mae", "rmse"]
        assert len(pr) == 100
        cal = pd.read_csv(paths["calibration.csv"])
        assert list(cal.columns) == ["Expected Conf.", "Observed Conf."]
        assert len(cal) == 41

    def test_precision_recall_matches_loop_oracle(self, rng):
        """Vectorized suffix-sum sparsification == the reference's loop."""
        import pandas as pd

        n = 500
        df = pd.DataFrame(
            {
                "combined_std": rng.uniform(size=n),
                "error": rng.uniform(size=n),
            }
        )
        got = create_precision_recall(df)
        # loop oracle (reference test_nyuv2_depth.py:133-144)
        sdf = df.sort_values(by="combined_std", ascending=False)
        percentiles = np.arange(100) / 100.0
        cutoffs = (percentiles * n).astype(int)
        mae = [sdf.iloc[c:]["error"].mean() for c in cutoffs]
        rmse = [np.sqrt(np.square(sdf.iloc[c:]["error"]).mean()) for c in cutoffs]
        np.testing.assert_allclose(got["mae"], mae, rtol=1e-10)
        np.testing.assert_allclose(got["rmse"], rmse, rtol=1e-10)

    def test_calibration_matches_scipy_oracle(self, rng):
        import pandas as pd
        import scipy.stats

        n = 300
        df = pd.DataFrame(
            {
                "y_true": rng.uniform(size=n),
                "y_pred": rng.uniform(size=n),
                "aleatoric_std": rng.uniform(0.01, 0.3, size=n),
            }
        )
        got = create_calibration(df)
        # direct oracle (reference test_nyuv2_depth.py:151-166)
        expected_p = np.arange(41) / 40.0
        ppfs = np.array(
            [
                scipy.stats.norm.ppf(
                    p, loc=df["y_pred"], scale=df["aleatoric_std"] / np.sqrt(2)
                )
                for p in expected_p
            ]
        )
        observed = (df["y_true"].to_numpy()[None, :] < ppfs).mean(axis=1)
        np.testing.assert_allclose(got["Observed Conf."], observed, atol=1e-12)
        assert got["Observed Conf."].iloc[0] == 0.0  # ppf(0) = -inf
        assert got["Observed Conf."].iloc[-1] == 1.0  # ppf(1) = +inf

    def test_evidential_predictions(self, tiny_dataset, tmp_path):
        task = EvidentialUnetTask(in_channels=3, filter_base_count=4, seed=0)
        tx = task.make_optimizer(2)
        state = task.init_state(2)
        img = jnp.asarray(tiny_dataset[np.arange(4)]["image"])
        lbl = jnp.asarray(tiny_dataset[np.arange(4)]["label"])
        for _ in range(2):
            state, _, _ = task.train_step(
                tx, state, {"image": img, "label": lbl}, jax.random.key(0)
            )
        preds = make_predictions_evidential(
            task, state.params, state.model_state, tiny_dataset,
            batch_size=4, epsilon=0.02,
        )
        inputs, y_pred, y_true, ale, epi, comb = preds
        assert y_pred.shape == (7, 32, 32)
        assert (ale > 0).all() and (epi > 0).all()
        write_artifacts(str(tmp_path), "ev", 0.02, preds)
