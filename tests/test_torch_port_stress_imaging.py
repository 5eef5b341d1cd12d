"""The port's PPMI stress test and imaging-upgrade suite
(``pd_fusion_torch/scripts/ppmi_{stress_test,imaging_upgrade}.py``) against
the JAX package's scripts on the JAX tests' own baseline frame
(``tests/test_ppmi_suites.py``), on the CPU.

What is held, and how close:
- the stress MLP fed the JAX script's draws (initial weights from
  ``PRNGKey(seed)``; permutations, per-sample keeps and dropout keeps split
  from ``PRNGKey(seed + 1)`` as ``ppmi_stress_test.py:123-135`` splits
  them): the trained weights within 1e-5;
- the whole stress test, the port fed the same draws: the same artifacts
  and rows, the MLP's metrics within 1e-3 (the tolerance
  ``tests/test_torch_port_tabular_cv.py`` holds runs fed the JAX draws to) and the host tree arm's within 1e-6 (scikit-learn's
  HistGradientBoosting on both sides, on the same median-imputed and
  scaled matrix, which equals scikit-learn's bit for bit; the float32
  metric reductions of the two packages round differently);
- the imaging upgrade under each harmonization (none, site z-score, ComBat
  falling back to the site z-score): every artifact of
  ``test_ppmi_suites.py:87-124`` plus the plots, the JSON audits equal,
  ``predictions.csv`` equal but for the probabilities, the tree arm's
  metrics and probabilities equal, the logistic arm's probabilities and
  metrics within 1e-3 (scikit-learn's lbfgs stops at ``tol=1e-4``, the
  port's Newton fit at the optimum: ``tests/test_torch_port_ppmi_suites.py``)
  but for the thresholded metrics (balanced accuracy, F1, ECE) of a fold
  with a probability within 1e-3 of 0.5 or of an ECE bin edge, where that
  probability may fall on either side (the one-feature ``freesurfer_only``
  setting's probabilities crowd 0.5); the univariate AUCs within 1e-6;
- the endpoints: conversion and progression labels and the ``visit_id``
  month recovery equal;
- the SHAP leg with the device GBDT on both sides
  (``PD_FUSION_GBDT_BACKEND=device``, 30 of the suites' 300 trees, as
  ``test_torch_port_ppmi_suites.py`` grows them): the tree arm's metrics
  within 1e-6 and every feature's mean |SHAP| within 1e-5, the TreeSHAP
  tolerance against the JAX package in ``tests/test_torch_port_gbdt.py``;
- both scripts with every ``sklearn`` and ``matplotlib`` module blocked and
  the device GBDT forced: the card's path needs neither.
"""
import json
import logging
import sys

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from pd_fusion_torch.analysis.tabular import SUITE_GBDT
from pd_fusion_torch.scripts import ppmi_imaging_upgrade as TI
from pd_fusion_torch.scripts import ppmi_stress_test as TS
from test_ppmi_suites import _load_script, baseline_df  # noqa: F401  (the JAX tests' fixture)
from test_torch_port_jax_draws import JaxKey, dropout_keeps, one_cpu_thread

METRICS = ["balanced_accuracy", "brier_score", "ece", "f1", "pr_auc", "roc_auc"]
DEVICE_ROUNDS = 30
LOG = logging.getLogger("t")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("PD_FUSION_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("PD_FUSION_GBDT_BACKEND", raising=False)
    monkeypatch.delenv("PD_FUSION_GBDT_HIST", raising=False)
    with one_cpu_thread():
        yield


# ---------------------------------------------------------------------------
# the stress test
# ---------------------------------------------------------------------------


def _jax_stress_draws(g, epochs, n, batch_size, moddrop_prob, dropout, device):
    """The JAX script's draws from its training key, in its split order."""
    nb = -(-n // batch_size)
    perms, keeps, dks = [], [], []
    for ek in jax.random.split(g.key, epochs):
        pk, ek = jax.random.split(ek)
        perms.append(np.asarray(jax.random.permutation(pk, n)))
        ke, de = [], []
        for bk in jax.random.split(ek, nb):
            mk, dk = jax.random.split(bk)
            ke.append(np.asarray(jax.random.uniform(mk, (batch_size, 2)) > moddrop_prob,
                                 np.float32))
            de.append(dropout_keeps(dk, dropout, [(batch_size, h) for h in TS.HIDDEN]))
        keeps.append(ke)
        dks.append(de)
    t = lambda a: torch.tensor(np.array(a), device=device)  # noqa: E731
    return (t(perms), t(keeps),
            [t([[b[li] for b in e] for e in dks]) for li in range(len(TS.HIDDEN))])


def _jax_stress_seams(monkeypatch):
    from pd_fusion.nn import mlp as JM
    from pd_fusion_torch.nn.mlp import mlp_params_from_jax

    monkeypatch.setattr(TS, "mlp_generators", lambda seed, device: (
        JaxKey(jax.random.PRNGKey(seed)), JaxKey(jax.random.PRNGKey(seed + 1))))
    monkeypatch.setattr(TS, "mlp_init", lambda g, dims, device=None: mlp_params_from_jax(
        jax.tree_util.tree_map(np.asarray, JM.mlp_init(g.key, list(dims))), device=device))
    monkeypatch.setattr(TS, "draw_stress", _jax_stress_draws)


def _stress_inputs(df):
    groups = TS.build_groups(df)
    X = TS.scaled_features(df, groups["full"])
    col = {c: i for i, c in enumerate(groups["full"])}
    return X, df["label"].values.astype(int), {
        g: [col[c] for c in groups[g]] for g in ("clinical", "imaging")}


def test_stress_mlp_fed_the_jax_draws_reaches_the_jax_weights(baseline_df, monkeypatch):  # noqa: F811
    jax_script = _load_script("ppmi_stress_test")
    X, y, group_idx = _stress_inputs(baseline_df.dropna(subset=["label"]))
    X_tr, y_tr = X[:90], y[:90]
    args = (X_tr, y_tr, group_idx, 0.3, 4, 32, 1e-3, 7)
    predict = jax_script.train_moddrop_mlp_jax(*args)
    want = predict.__closure__[predict.__code__.co_freevars.index("trained")].cell_contents
    _jax_stress_seams(monkeypatch)
    got = TS.train_moddrop_mlp(*args)
    for g, w in zip(got.params, want):
        for k in ("w", "b"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), rtol=0, atol=1e-5)
    for drop in ({}, {"clinical": True}, {"imaging": True}):
        np.testing.assert_allclose(got(X[90:], drop), predict(X[90:], drop), rtol=0, atol=1e-5)


def test_scaled_features_equal_scikit_learns(baseline_df):  # noqa: F811
    from sklearn.impute import SimpleImputer
    from sklearn.preprocessing import StandardScaler

    groups = TS.build_groups(baseline_df)
    X = TS.select_numeric(baseline_df, groups["full"])
    want = StandardScaler().fit_transform(SimpleImputer(strategy="median").fit_transform(X))
    np.testing.assert_array_equal(TS.scaled_features(baseline_df, groups["full"]), want)


def test_stress_test_equals_the_jax_script(baseline_df, tmp_path, monkeypatch):  # noqa: F811
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
    kw = dict(folds=3, epochs=5, batch_size=32, logger=LOG)
    want = _load_script("ppmi_stress_test").run_stress_test(baseline_df, tmp_path / "jax", **kw)
    _jax_stress_seams(monkeypatch)
    got = TS.run_stress_test(baseline_df, tmp_path / "port", **kw)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax").iterdir())
    assert list(got.columns) == list(want.columns) and len(got) == 2 * 3 * 3
    pd.testing.assert_frame_equal(got[["model", "scenario", "fold"]],
                                  want[["model", "scenario", "fold"]])
    for model, atol in (("moddrop_mlp", 1e-3), ("lgbm", 1e-6)):
        rows = got["model"] == model
        np.testing.assert_allclose(got.loc[rows, METRICS], want.loc[rows, METRICS], rtol=0,
                                   atol=atol, err_msg=model)
    a, b = (pd.read_csv(tmp_path / k / "stress_test_summary.csv") for k in ("port", "jax"))
    assert list(a.columns) == list(b.columns) and len(a) == len(b) == 6
    assert set(TS.LAST_TIMINGS) == {"prep_s", "lgbm_s", "mlp_s", "metrics_s", "total_s"}


# ---------------------------------------------------------------------------
# the imaging upgrade
# ---------------------------------------------------------------------------

ARTIFACTS = (
    "kept_dropped_columns.json", "imaging_columns.json", "imaging_availability_summary.json",
    "imaging_missingness_per_feature.csv", "imaging_missingness_per_subject.csv",
    "covariates_used.json", "per_fold_metrics.csv", "predictions.csv", "summary_mean.csv",
    "feature_importance.csv", "univariate_top.csv", "permutation_test.csv", "paired_tests.json",
)
PLOTS = ("roc_auc_bar.png", "roc_curves.png", "calibration_curves.png")


def _upgrade_cfg(df, tmp_path, harmonization="none", models=("logreg", "lgbm"), seeds=(0,),
                 **extra):
    tmp_path.mkdir(exist_ok=True)
    df = df.copy()
    df["mri_derived__SITE"] = np.where(np.arange(len(df)) % 3 == 0, "A", "B")
    df.to_csv(tmp_path / "baseline.csv", index=False)
    v2 = df.copy()
    v2["visit_id"] = "V04"
    v2["visit_month"] = 12
    pd.concat([df, v2]).to_csv(tmp_path / "visits.csv", index=False)
    return {
        "baseline_csv": str(tmp_path / "baseline.csv"),
        "visit_csv": str(tmp_path / "visits.csv"),
        "endpoint": {"type": "pd_vs_hc"},
        "cv": {"folds": 3, "seeds": list(seeds)},
        "covariates": {"numeric": ["age"], "categorical": ["sex"]},
        "harmonization": {"method": harmonization, "site_cols": ["mri_derived__SITE"]},
        "models": list(models),
        **extra,
    }


def _upgrade_both(cfg, tmp_path, no_plot=False, no_shap=True):
    out = {}
    for name, run in (("jax", _load_script("ppmi_imaging_upgrade").run_imaging_upgrade),
                      ("port", TI.run_imaging_upgrade)):
        (tmp_path / name).mkdir()
        out[name] = run(cfg, tmp_path / name, no_plot=no_plot, no_shap=no_shap, logger=LOG)
    return out["port"], out["jax"]


def _csv(tmp_path, name):
    return tuple(pd.read_csv(tmp_path / k / name) for k in ("port", "jax"))


@pytest.mark.parametrize("harmonization", ["none", "site_zscore", "combat"])
def test_imaging_upgrade_equals_the_jax_script(baseline_df, tmp_path, harmonization):  # noqa: F811
    cfg = _upgrade_cfg(baseline_df, tmp_path / "data", harmonization)
    got, want = _upgrade_both(cfg, tmp_path, no_plot=harmonization != "none")
    files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert set(ARTIFACTS) <= set(files)
    if harmonization == "none":
        assert set(PLOTS) <= set(files)
    for name in ("kept_dropped_columns.json", "imaging_columns.json",
                 "imaging_availability_summary.json", "covariates_used.json",
                 "paired_tests.json"):
        a, b = (json.loads((tmp_path / k / name).read_text()) for k in ("port", "jax"))
        if name == "paired_tests.json" and "logreg" in cfg["models"]:
            a.pop("p_value"), b.pop("p_value")  # lgbm-only contrast; equal below
        assert a == b, name
    cols = json.loads((tmp_path / "port" / "imaging_columns.json").read_text())
    assert any(c.endswith("_ASYM") for c in cols["datsbr"])
    for name in ("imaging_missingness_per_feature.csv", "imaging_missingness_per_subject.csv"):
        pd.testing.assert_frame_equal(*_csv(tmp_path, name))
    key = ["seed", "fold", "setting", "model"]
    assert list(got.columns) == list(want.columns)
    pd.testing.assert_frame_equal(got[key], want[key])
    rows = got["model"] == "lgbm"
    pd.testing.assert_frame_equal(got[rows], want[rows])
    a, b = _csv(tmp_path, "predictions.csv")
    pd.testing.assert_frame_equal(a.drop(columns="y_prob"), b.drop(columns="y_prob"))
    lg = a["model"] == "lgbm"
    pd.testing.assert_frame_equal(a[lg], b[lg])
    np.testing.assert_allclose(a.loc[~lg, "y_prob"], b.loc[~lg, "y_prob"], rtol=0, atol=1e-3)
    edges = np.concatenate([[0.5], np.linspace(0.0, 1.0, 11)])
    for i in np.flatnonzero(~rows.to_numpy()):
        row = got.iloc[i]
        fold = a[(a["model"] == "logreg") & (a["seed"] == row["seed"])
                 & (a["fold"] == row["fold"]) & (a["setting"] == row["setting"])]
        near = (np.abs(fold["y_prob"].to_numpy()[:, None] - edges) <= 1e-3).any()
        held = [m for m in METRICS if not (near and m in ("balanced_accuracy", "f1", "ece"))]
        np.testing.assert_allclose(got.iloc[i][held].astype(float),
                                   want.iloc[i][held].astype(float), rtol=0, atol=1e-3,
                                   err_msg=str(row[key].to_dict()))
    a, b = _csv(tmp_path, "univariate_top.csv")
    pd.testing.assert_frame_equal(a.drop(columns="auc"), b.drop(columns="auc"))
    np.testing.assert_allclose(a["auc"], b["auc"], rtol=0, atol=1e-6)
    a, b = _csv(tmp_path, "permutation_test.csv")
    pd.testing.assert_frame_equal(a.drop(columns="roc_auc"), b.drop(columns="roc_auc"))
    p_port, p_jax = (json.loads((tmp_path / k / "paired_tests.json").read_text())["p_value"]
                     for k in ("port", "jax"))
    assert p_port == p_jax


def _visits_without_months(df):
    rng = np.random.RandomState(1)
    base = df.copy()
    base["mds_updrs__NP3TOT"] = rng.rand(len(base)) * 20
    base["visit_month"] = np.nan
    later = []
    for code, bump in (("V04", 8.0), ("V06", 2.0), ("V10", 9.0)):
        v = base.copy()
        v["visit_id"] = code
        v["mds_updrs__NP3TOT"] = base["mds_updrs__NP3TOT"] + np.where(
            rng.rand(len(v)) < 0.5, bump, 1.0)
        v["label"] = np.where(rng.rand(len(v)) < 0.2, 1, base["label"])
        later.append(v)
    return base, pd.concat([base] + later, ignore_index=True)


@pytest.mark.parametrize("endpoint", [
    {"type": "progression", "horizon_months": 6, "progression_feature": "mds_updrs__NP3TOT",
     "progression_threshold": 5.0, "progression_max_months": 12},
    {"type": "progression_24m", "horizon_months": 24, "progression_feature": "mds_updrs__NP3TOT",
     "progression_threshold": 5.0, "progression_allow_beyond_horizon": False},
    {"type": "conversion_24m", "horizon_months": 5},
    {"type": "pd_vs_hc"},
], ids=["progression-beyond", "progression-within", "conversion", "pd_vs_hc"])
def test_endpoint_labels_equal_the_jax_script(baseline_df, endpoint):  # noqa: F811
    """visit_month all NaN: both recover it from the visit_id codes."""
    jax_script = _load_script("ppmi_imaging_upgrade")
    base, visits = _visits_without_months(baseline_df)
    want = jax_script.build_endpoint_labels(base, visits, endpoint, LOG)
    got = TI.build_endpoint_labels(base, visits, endpoint, LOG)
    pd.testing.assert_frame_equal(got, want)
    assert set(got["label"].unique()) <= {0, 1}


def _device_gbdt_both(monkeypatch):
    """Both packages' tree arms on their device trainers, DEVICE_ROUNDS trees."""
    from pd_fusion.nn import gbdt as JG

    class FewerTrees(JG.DeviceHistGBDT):
        def __init__(self, **kw):
            super().__init__(**dict(kw, n_estimators=DEVICE_ROUNDS))

    monkeypatch.setenv("PD_FUSION_GBDT_BACKEND", "device")
    monkeypatch.setattr(JG, "DeviceHistGBDT", FewerTrees)
    monkeypatch.setitem(SUITE_GBDT, "n_estimators", DEVICE_ROUNDS)


def test_imaging_upgrade_shap_leg_equals_the_jax_leg(baseline_df, tmp_path, monkeypatch):  # noqa: F811
    cfg = _upgrade_cfg(baseline_df, tmp_path / "data", models=("lgbm",))
    _device_gbdt_both(monkeypatch)
    got, want = _upgrade_both(cfg, tmp_path, no_plot=True, no_shap=False)
    np.testing.assert_allclose(got[METRICS], want[METRICS], rtol=0, atol=1e-6)
    a, b = _csv(tmp_path, "shap_summary.csv")
    assert len(a) == len(b) > 0 and set(a["feature"]) == set(b["feature"])
    merged = a.merge(b, on="feature", suffixes=("", "_jax"))
    np.testing.assert_allclose(merged["mean_abs_shap"], merged["mean_abs_shap_jax"], rtol=0,
                               atol=1e-5)
    assert merged["mean_abs_shap"].max() > 0
    assert TI.LAST_SHAP["trees"] == DEVICE_ROUNDS and TI.LAST_SHAP["chunks"] == 1


def test_shap_leg_without_the_shap_package_warns_and_skips(baseline_df, tmp_path, caplog):  # noqa: F811
    """A logistic winner (and the host tree) needs the shap package."""
    cfg = _upgrade_cfg(baseline_df, tmp_path / "data", models=("logreg",))
    (tmp_path / "run").mkdir()
    with caplog.at_level(logging.WARNING, logger="t"):
        TI.run_imaging_upgrade(cfg, tmp_path / "run", no_plot=True, no_shap=False, logger=LOG)
    assert not (tmp_path / "run" / "shap_summary.csv").exists()
    assert "SHAP summary skipped" in caplog.text


def test_both_scripts_run_without_scikit_learn_or_matplotlib(baseline_df, tmp_path,  # noqa: F811
                                                             monkeypatch):
    for top in ("sklearn", "matplotlib"):
        for name in [m for m in sys.modules if m.split(".")[0] == top]:
            monkeypatch.setitem(sys.modules, name, None)
        monkeypatch.setitem(sys.modules, top, None)
    monkeypatch.setenv("PD_FUSION_GBDT_BACKEND", "device")
    monkeypatch.setitem(SUITE_GBDT, "n_estimators", DEVICE_ROUNDS)
    with pytest.raises(ImportError):
        import sklearn.linear_model  # noqa: F401
    (tmp_path / "stress").mkdir()
    out = TS.run_stress_test(baseline_df, tmp_path / "stress", folds=3, epochs=2, batch_size=32,
                             logger=LOG)
    assert len(out) == 18 and np.isfinite(out[METRICS].to_numpy()).all()
    assert {p.name for p in (tmp_path / "stress").iterdir()} == {
        "stress_test_per_fold.csv", "stress_test_summary.csv"}
    cfg = _upgrade_cfg(baseline_df, tmp_path / "data", "combat",
                       cohort={"imaging_available_only": True, "require_dat": True})
    (tmp_path / "up").mkdir()
    per_fold = TI.run_imaging_upgrade(cfg, tmp_path / "up", no_plot=False, no_shap=False,
                                      logger=LOG)
    assert len(per_fold) == 4 * 2 * 3 and np.isfinite(per_fold[METRICS].to_numpy()).all()
    files = {p.name for p in (tmp_path / "up").iterdir()}
    assert set(ARTIFACTS) <= files and not set(PLOTS) & files
    assert "shap_summary.csv" in files or not (per_fold.groupby("model")["roc_auc"].mean()
                                               .idxmax() == "lgbm")
