"""Offline evaluation: predictions, uncertainty artifacts, sparsification
and calibration curves.

Reproduces the reference eval pipeline and artifact set (reference:
scripts/test/test_nyuv2_depth.py:26-170, artifact list Readme.md:87-94):
  {name}_{eps}_inputs.npy, _y_preds.npy, _y_trues.npy, _aleatoric_vars.npy,
  _epistemic_vars.npy, _metrics.pkl (per-pixel dataframe),
  _precision_recall.csv, _calibration.csv

Differences from the reference: FGSM + forward run as one jitted program per batch
shape; the calibration ppf sweep is one vectorized numpy/scipy expression
instead of a multiprocessing pool (test_nyuv2_depth.py:160-163).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from mimo_unet_tpu.eval.fgsm import make_fgsm_fn


def _pad_to(batch_arrays, size):
    """Pad arrays along axis 0 up to ``size`` (repeat last row)."""
    out = []
    for a in batch_arrays:
        if len(a) < size:
            pad = np.repeat(a[-1:], size - len(a), axis=0)
            a = np.concatenate([a, pad], axis=0)
        out.append(a)
    return out


def make_predictions(
    ensemble,
    dataset,
    batch_size: int = 5,
    epsilon: float = 0.0,
    rng: Optional[jax.Array] = None,
) -> Tuple[np.ndarray, ...]:
    """Run the ensemble over a dataset with optional FGSM noise.

    Returns (inputs, y_pred_mean, y_true, aleatoric_var, epistemic_var,
    combined_var) as numpy arrays; the channel axis is reduced to channel 0
    like the reference (test_nyuv2_depth.py:83-89).
    """
    if rng is None:
        rng = jax.random.key(0)
    fgsm = jax.jit(make_fgsm_fn(ensemble, epsilon))
    loss_fn = ensemble.loss_fn

    inputs, y_preds, y_trues, log_params = [], [], [], []
    n = len(dataset)
    for start in range(0, n, batch_size):
        idx = np.arange(start, min(start + batch_size, n))
        batch = dataset[idx]
        real = len(idx)
        image, label = _pad_to([batch["image"], batch["label"]], batch_size)
        x, p1, p2 = fgsm(
            jnp.asarray(image), jnp.asarray(label), jax.random.fold_in(rng, start)
        )
        inputs.append(np.asarray(x)[:real])
        y_preds.append(np.asarray(p1)[:real])
        log_params.append(np.asarray(p2)[:real])
        y_trues.append(np.asarray(label)[:real])

    inputs = np.concatenate(inputs, axis=0)
    y_preds = np.concatenate(y_preds, axis=0).clip(0, 1)
    y_trues = np.concatenate(y_trues, axis=0).clip(0, 1)
    log_params = np.concatenate(log_params, axis=0)

    # uncertainty decomposition on the clipped predictions, matching
    # test_nyuv2_depth.py:73-81 (aleatoric from log_params, epistemic from
    # the clipped per-subnetwork means)
    stds = np.asarray(loss_fn.std(jnp.asarray(y_preds), jnp.asarray(log_params)))
    aleatoric_var = np.square(stds).mean(axis=1)
    s = y_preds.shape[1]
    if s > 1:
        mu_bar = y_preds.mean(axis=1, keepdims=True)
        epistemic_var = np.square(y_preds - mu_bar).sum(axis=1) / (s - 1)
    else:
        epistemic_var = np.zeros_like(aleatoric_var)

    # channel 0 slice (single-target evaluation, test_nyuv2_depth.py:83-89)
    return (
        inputs,
        y_preds.mean(axis=1)[..., 0],
        y_trues[..., 0],
        aleatoric_var[..., 0],
        epistemic_var[..., 0],
        aleatoric_var[..., 0] + epistemic_var[..., 0],
    )


def make_predictions_evidential(
    task,
    params,
    model_state,
    dataset,
    batch_size: int = 5,
    epsilon: float = 0.0,
) -> Tuple[np.ndarray, ...]:
    """Evidential variant: FGSM on the NIG loss, closed-form uncertainties
    (reference scripts/test/test_nyuv2_depth_evidential.py:27-86)."""
    loss_fn = task.loss_fn

    def attack_and_predict(image, label):
        def nll(img):
            out, _ = task.forward(params, model_state, img, train=False)
            return loss_fn(out, label, reduce_mean=True)

        if epsilon > 0.0:
            from mimo_unet_tpu.eval.fgsm import fgsm_attack

            grad = jax.grad(nll)(image)
            image = fgsm_attack(image, epsilon, grad)
        out, _ = task.forward(params, model_state, image, train=False)
        return image, out

    fn = jax.jit(attack_and_predict)

    inputs, y_preds, y_trues, ale, epi = [], [], [], [], []
    n = len(dataset)
    for start in range(0, n, batch_size):
        idx = np.arange(start, min(start + batch_size, n))
        batch = dataset[idx]
        real = len(idx)
        image, label = _pad_to([batch["image"], batch["label"]], batch_size)
        x, out = fn(jnp.asarray(image), jnp.asarray(label))
        out = np.asarray(out)[:real]
        inputs.append(np.asarray(x)[:real])
        y_preds.append(np.asarray(loss_fn.mode(out)))
        ale.append(np.asarray(loss_fn.aleatoric_var(out)))
        epi.append(np.asarray(loss_fn.epistemic_var(out)))
        y_trues.append(np.asarray(label)[:real, ..., 0])

    inputs = np.concatenate(inputs, axis=0)
    y_preds = np.concatenate(y_preds, axis=0).clip(0, 1)
    y_trues = np.concatenate(y_trues, axis=0).clip(0, 1)
    aleatoric_var = np.concatenate(ale, axis=0)
    epistemic_var = np.concatenate(epi, axis=0)
    return (
        inputs,
        y_preds,
        y_trues,
        aleatoric_var,
        epistemic_var,
        aleatoric_var + epistemic_var,
    )


def convert_to_dataframe(y_preds, y_trues, aleatoric_vars, epistemic_vars, combined_vars):
    """Per-pixel dataframe with error column (test_nyuv2_depth.py:93-106,128-130)."""
    import pandas as pd

    df = pd.DataFrame(
        {
            "y_pred": np.asarray(y_preds).ravel(),
            "y_true": np.asarray(y_trues).ravel(),
            "aleatoric_std": np.sqrt(np.asarray(aleatoric_vars)).ravel(),
            "epistemic_std": np.sqrt(np.asarray(epistemic_vars)).ravel(),
            "combined_std": np.sqrt(np.asarray(combined_vars)).ravel(),
        }
    )
    df["error"] = np.abs(df["y_pred"] - df["y_true"])
    return df


def create_precision_recall(df) -> "pd.DataFrame":
    """Sparsification curve: drop the most-uncertain tail, track MAE/RMSE.

    Matches test_nyuv2_depth.py:133-144 but vectorized: sort by combined_std
    descending, then suffix means via reversed cumulative sums instead of a
    Python loop over 100 percentile cutoffs.
    """
    import pandas as pd

    order = np.argsort(-df["combined_std"].to_numpy(), kind="stable")
    err = df["error"].to_numpy()[order]
    n = err.shape[0]

    percentiles = np.arange(100) / 100.0
    cutoffs = (percentiles * n).astype(int)

    # suffix sums: sum of err[k:] for any k, O(n)
    cum = np.concatenate([[0.0], np.cumsum(err, dtype=np.float64)])
    cum_sq = np.concatenate([[0.0], np.cumsum(np.square(err, dtype=np.float64))])
    counts = (n - cutoffs).astype(np.float64)
    mae = (cum[-1] - cum[cutoffs]) / counts
    mse = (cum_sq[-1] - cum_sq[cutoffs]) / counts

    return pd.DataFrame({"percentile": percentiles, "mae": mae, "rmse": np.sqrt(mse)})


def create_calibration(df, distribution=None, subsample: Optional[float] = None,
                       seed: int = 0) -> "pd.DataFrame":
    """Calibration curve over 41 expected-confidence levels.

    Matches test_nyuv2_depth.py:147-170: observed confidence = fraction of
    y_true below ``distribution.ppf(p, loc=y_pred, scale=aleatoric_std/sqrt(2))``.
    Vectorized over all levels at once (no mp.Pool).  ``subsample`` mirrors
    the NDVI variant's 50% pixel subsampling (test_ndvi.py:195).
    """
    import pandas as pd
    import scipy.stats

    if distribution is None:
        distribution = scipy.stats.norm

    y_true = df["y_true"].to_numpy()
    y_pred = df["y_pred"].to_numpy()
    aleatoric_std = df["aleatoric_std"].to_numpy()
    if subsample is not None and subsample < 1.0:
        rng = np.random.default_rng(seed)
        keep = rng.random(y_true.shape[0]) < subsample
        y_true, y_pred, aleatoric_std = y_true[keep], y_pred[keep], aleatoric_std[keep]

    expected_p = np.arange(41) / 40.0
    # ppf(p; loc, scale) = loc + scale * ppf(p; 0, 1) for loc-scale families:
    # one standard-ppf evaluation, then an outer broadcast.
    std_ppf = distribution.ppf(expected_p)  # [41]
    scale = aleatoric_std / np.sqrt(2.0)
    below = y_true[None, :] < (y_pred[None, :] + std_ppf[:, None] * scale[None, :])
    observed_p = below.mean(axis=1)
    return pd.DataFrame({"Expected Conf.": expected_p, "Observed Conf.": observed_p})


def write_artifacts(
    result_dir: str,
    dataset_name: str,
    noise_level: float,
    predictions: Tuple[np.ndarray, ...],
    calibration_subsample: Optional[float] = None,
) -> dict:
    """Write the full reference artifact set for one (dataset, eps) cell.

    Returns {artifact_name: path}.
    """
    inputs, y_preds, y_trues, aleatoric_vars, epistemic_vars, combined_vars = predictions
    os.makedirs(result_dir, exist_ok=True)
    paths = {}

    def p(suffix):
        path = os.path.join(result_dir, f"{dataset_name}_{noise_level}_{suffix}")
        paths[suffix] = path
        return path

    np.save(p("inputs.npy"), inputs)
    np.save(p("y_preds.npy"), y_preds)
    np.save(p("y_trues.npy"), y_trues)
    np.save(p("aleatoric_vars.npy"), aleatoric_vars)
    np.save(p("epistemic_vars.npy"), epistemic_vars)

    df = convert_to_dataframe(y_preds, y_trues, aleatoric_vars, epistemic_vars, combined_vars)
    df.to_pickle(p("metrics.pkl"))
    create_precision_recall(df).to_csv(p("precision_recall.csv"), index=False)
    create_calibration(df, subsample=calibration_subsample).to_csv(
        p("calibration.csv"), index=False
    )
    return paths
