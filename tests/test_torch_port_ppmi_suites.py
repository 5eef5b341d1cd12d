"""The port's PPMI suite scripts (``pd_fusion_torch/scripts/ppmi_*``)
against the JAX package's (``scripts/ppmi_*``) on the JAX tests' own
fixtures (CPU): ``tests/test_ppmi_tabular_suite.py``'s built study data for
the sweep and the report, ``tests/test_ppmi_suites.py``'s baseline frame
for the meaningful suite.

What is held, and how close:
- the same artifact files, and the same columns in every CSV;
- logreg: every metric within 1e-3 (scikit-learn's lbfgs stops at
  ``tol=1e-4``, the port's Newton fit at the optimum), |coef| importances
  within 2e-3;
- lgbm under the host backend (scikit-learn's HistGradientBoosting on both
  sides, as the JAX scripts fall back to it where LightGBM is absent):
  equal; under ``PD_FUSION_GBDT_BACKEND=device`` on both sides (the JAX
  sweep's tree factory pointed at the JAX device GBDT with the same
  settings, as the port's resolves), probabilities, metrics and gain
  importances within 1e-6, PR 4's tolerance for the device GBDT against
  the JAX package's (``tests/test_torch_port_gbdt.py``); those two runs
  grow 30 of the suites' 300 trees on both sides, for CPU time;
- mlp, fed the JAX run's initial weights and dropout keys
  (``test_torch_port_jax_draws.use_jax_draws``): every metric within 1e-3;
- the screens: ``univariate_top.csv`` equal up to 1e-6 on the AUCs,
  ``permutation_test.csv`` within one held-out pair per repeat (see
  ``tests/test_torch_port_analysis_tabular.py``);
- both suites run with every ``sklearn`` module blocked and the device
  GBDT forced: the card's path needs no scikit-learn;
- the fold-batched GBDT fit equals the one-at-a-time fits bit for bit.
"""
import json
import logging
import sys

import jax
import numpy as np
import pandas as pd
import pytest

from pd_fusion_torch.analysis import tabular_checks
from pd_fusion_torch.analysis.tabular import SUITE_GBDT
from pd_fusion_torch.scripts import ppmi_eval_report as TR
from pd_fusion_torch.scripts import ppmi_meaningful_suite as TMS
from pd_fusion_torch.scripts import ppmi_train_tabular as TTT
from test_ppmi_suites import _load_script, baseline_df  # noqa: F401  (the JAX tests' fixture)
from test_ppmi_tabular_suite import built_dataset  # noqa: F401  (the JAX tests' fixture)
from test_torch_port_jax_draws import JaxKey, one_cpu_thread, use_jax_draws

METRICS = ["balanced_accuracy", "brier_score", "ece", "f1", "pr_auc", "roc_auc"]
DEVICE_ROUNDS = 30


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("PD_FUSION_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("PD_FUSION_GBDT_BACKEND", raising=False)
    monkeypatch.delenv("PD_FUSION_GBDT_HIST", raising=False)
    with one_cpu_thread():
        yield


def _jax_mlp_draws(monkeypatch):
    """The port sweep's MLP arm draws the JAX script's init and dropout keys."""
    from pd_fusion_torch.nn import mlp as TM

    use_jax_draws(monkeypatch)
    monkeypatch.setattr(TTT, "mlp_init", TM.mlp_init)
    monkeypatch.setattr(TTT, "mlp_generators", lambda seed, device: (
        JaxKey(jax.random.PRNGKey(seed)), JaxKey(jax.random.PRNGKey(seed + 1))))


def _device_gbdt_both(monkeypatch):
    """Both packages' GBDT arms on their device trainers, DEVICE_ROUNDS trees."""
    from pd_fusion.nn import gbdt as JG

    class FewerTrees(JG.DeviceHistGBDT):
        def __init__(self, **kw):
            super().__init__(**dict(kw, n_estimators=DEVICE_ROUNDS))

    monkeypatch.setenv("PD_FUSION_GBDT_BACKEND", "device")
    monkeypatch.setattr(JG, "DeviceHistGBDT", FewerTrees)
    monkeypatch.setitem(SUITE_GBDT, "n_estimators", DEVICE_ROUNDS)
    return FewerTrees


def _files(path):
    return sorted(p.name for p in path.iterdir())


def _sweep_both(cfg, tmp_path, jax_tree=None):
    jax_sweep = _load_script("ppmi_train_tabular")
    if jax_tree is not None:  # the JAX script's factory does not resolve the backend
        jax_sweep.get_tree_model = lambda seed, logger, nt: jax_tree(
            random_state=seed, **{k: v for k, v in SUITE_GBDT.items() if k != "n_estimators"})
    want = jax_sweep.run_suite(cfg, tmp_path / "jax", seeds=[42], num_threads=1)
    got = TTT.run_suite(cfg, tmp_path / "port", seeds=[42], num_threads=1)
    return want, got


def _rows(frame, model):
    return frame[frame["model"] == model].reset_index(drop=True)


def test_sweep_and_report_equal_the_jax_scripts(built_dataset, tmp_path, monkeypatch):  # noqa: F811
    cfg, _ = built_dataset
    _jax_mlp_draws(monkeypatch)
    want, got = _sweep_both(cfg, tmp_path)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    for name in ["results_all.csv", "summary_sweep_mean.csv"] + [
            p for p in _files(tmp_path / "jax") if p.startswith("pred_")]:
        a, b = pd.read_csv(tmp_path / "port" / name), pd.read_csv(tmp_path / "jax" / name)
        assert list(a.columns) == list(b.columns), name
    assert list(got.columns) == list(want.columns)
    pd.testing.assert_frame_equal(got[["seed", "ablation", "model"]],
                                  want[["seed", "ablation", "model"]])
    for model, atol in (("logreg", 1e-3), ("mlp", 1e-3), ("lgbm", 0.0)):
        np.testing.assert_allclose(_rows(got, model)[METRICS], _rows(want, model)[METRICS],
                                   rtol=0, atol=atol, err_msg=model)
    for abl in ("clinical_only", "fusion"):
        name = f"pred_lgbm_{abl}_seed42.csv"
        pd.testing.assert_frame_equal(pd.read_csv(tmp_path / "port" / name),
                                      pd.read_csv(tmp_path / "jax" / name))

    from test_ppmi_suites import REPO

    monkeypatch.syspath_prepend(str(REPO / "scripts"))  # the JAX script imports _cli_common
    jax_report = _load_script("ppmi_eval_report")
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(json.dumps(cfg))  # YAML reads JSON
    for out, run in ((tmp_path / "port", TR.main),
                     (tmp_path / "jax", lambda argv: (monkeypatch.setattr(
                         sys, "argv", ["ppmi_eval_report"] + argv), jax_report.main()))):
        run(["--config", str(cfg_path), "--out_dir", str(out)])
    for name in ("summary_sweep_mean.csv", "ranking_table.csv"):
        a, b = pd.read_csv(tmp_path / "port" / name), pd.read_csv(tmp_path / "jax" / name)
        assert list(a.columns) == list(b.columns)
        assert list(a["model"]) == list(b["model"]) or name == "ranking_table.csv"
    assert (tmp_path / "port" / "ppmi_eval_report.log").exists()


def test_sweep_device_gbdt_equals_the_jax_device_gbdt(built_dataset, tmp_path,  # noqa: F811
                                                     monkeypatch):
    cfg, _ = built_dataset
    cfg = dict(cfg, models=["lgbm"])
    want, got = _sweep_both(cfg, tmp_path, jax_tree=_device_gbdt_both(monkeypatch))
    np.testing.assert_allclose(got[METRICS], want[METRICS], rtol=0, atol=1e-6)
    for abl in ("clinical_only", "fusion"):
        name = f"pred_lgbm_{abl}_seed42.csv"
        a, b = pd.read_csv(tmp_path / "port" / name), pd.read_csv(tmp_path / "jax" / name)
        np.testing.assert_allclose(a["y_prob"], b["y_prob"], rtol=0, atol=1e-6)


def _suite_both(df, tmp_path):
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
    _load_script("ppmi_meaningful_suite").run_suite(
        df, tmp_path / "jax", seed=0, no_plot=True, logger=logging.getLogger("t"))
    TMS.run_suite(df, tmp_path / "port", seed=0, no_plot=True, logger=logging.getLogger("t"))
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    out = {}
    for name in _files(tmp_path / "jax"):
        if name.endswith(".csv"):
            out[name] = tuple(pd.read_csv(tmp_path / k / name) for k in ("port", "jax"))
            assert list(out[name][0].columns) == list(out[name][1].columns), name
    assert (json.loads((tmp_path / "port" / "kept_dropped_columns.json").read_text())
            == json.loads((tmp_path / "jax" / "kept_dropped_columns.json").read_text()))
    return out


def _held_screens(out, df):
    got, want = out["univariate_top.csv"]
    pd.testing.assert_frame_equal(got.drop(columns="auc"), want.drop(columns="auc"))
    np.testing.assert_allclose(got["auc"], want["auc"], rtol=0, atol=1e-6)
    from pd_fusion_torch.analysis.tabular import permutation_inputs

    got, want = out["permutation_test.csv"]
    pd.testing.assert_frame_equal(got.drop(columns="roc_auc"), want.drop(columns="roc_auc"))
    settings = TMS.resolve_settings(df)
    for setting, rows in got.groupby("setting"):
        y_te = permutation_inputs(df, settings[setting], 5, 42)[4]
        pair = 1.0 / (y_te.sum(1) * (1 - y_te).sum(1))
        diff = np.abs(rows["roc_auc"].to_numpy() - want.loc[rows.index, "roc_auc"].to_numpy())
        assert (diff <= pair + 1e-6).all(), (setting, diff, pair)


def test_meaningful_suite_equals_the_jax_script(baseline_df, tmp_path):  # noqa: F811
    out = _suite_both(baseline_df, tmp_path)
    got, want = out["per_fold_metrics.csv"]
    pd.testing.assert_frame_equal(got[["setting", "model", "fold", "prevalence"]],
                                  want[["setting", "model", "fold", "prevalence"]])
    np.testing.assert_allclose(_rows(got, "logreg")[METRICS], _rows(want, "logreg")[METRICS],
                               rtol=0, atol=1e-3)
    pd.testing.assert_frame_equal(_rows(got, "lgbm"), _rows(want, "lgbm"))
    got, want = out["feature_importance.csv"]  # logreg |coef| (HistGB has none)
    key = ["setting", "model", "feature"]
    merged = got.merge(want, on=key, suffixes=("", "_jax"))
    assert len(merged) == len(got) == len(want)
    np.testing.assert_allclose(merged["importance"], merged["importance_jax"], rtol=0, atol=2e-3)
    _held_screens(out, baseline_df)


def test_meaningful_suite_device_gbdt_equals_the_jax_device_gbdt(baseline_df, tmp_path,  # noqa: F811
                                                                 monkeypatch):
    _device_gbdt_both(monkeypatch)
    out = _suite_both(baseline_df, tmp_path)
    got, want = out["per_fold_metrics.csv"]
    np.testing.assert_allclose(_rows(got, "lgbm")[METRICS], _rows(want, "lgbm")[METRICS],
                               rtol=0, atol=1e-6)
    got, want = out["feature_importance.csv"]
    for frame in (got, want):
        frame.drop(frame.index[frame["model"] == "logreg"], inplace=True)
    merged = got.merge(want, on=["setting", "model", "feature"], suffixes=("", "_jax"))
    assert len(merged) == len(got) == len(want) > 0
    np.testing.assert_allclose(merged["importance"], merged["importance_jax"], rtol=0, atol=1e-6)


def test_both_suites_run_without_scikit_learn(built_dataset, baseline_df, tmp_path,  # noqa: F811
                                              monkeypatch):
    """Every ``sklearn`` module blocked and the device GBDT forced: the path
    the card runs imports no scikit-learn."""
    for name in [m for m in sys.modules if m == "sklearn" or m.startswith("sklearn.")]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setenv("PD_FUSION_GBDT_BACKEND", "device")
    monkeypatch.setitem(SUITE_GBDT, "n_estimators", DEVICE_ROUNDS)
    with pytest.raises(ImportError):
        import sklearn.linear_model  # noqa: F401
    cfg, _ = built_dataset
    results = TTT.run_suite(cfg, tmp_path / "sweep", seeds=[42], num_threads=1)
    assert len(results) == 6 and np.isfinite(results[METRICS].to_numpy()).all()
    (tmp_path / "suite").mkdir()
    per_fold = TMS.run_suite(baseline_df, tmp_path / "suite", seed=0, no_plot=True,
                             logger=logging.getLogger("t"))
    assert len(per_fold) == 6 * 2 * 5 and np.isfinite(per_fold[METRICS].to_numpy()).all()
    assert (tmp_path / "suite" / "feature_importance.csv").exists()


def test_fold_batched_gbdt_fit_equals_the_one_at_a_time_fits():
    """``fit_gbdt_stack`` against each model's own ``fit`` with the suites'
    settings: rows and widths differ between the models, as the sweep's
    seeds and the suite's folds do."""
    got = tabular_checks.check_gbdt_stack("cpu", K=3, n=90, f=9, rounds=60)
    assert got == {"bitwise": True, "first_fork": None}
