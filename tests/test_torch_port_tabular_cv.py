"""Whole K-fold CV runs of the tabular slice through the port's CV engine
(folds as a batch dimension) and CLI, against the JAX package's runs of
the same frames.

- every flat family, calibrated, nested and not (N=200 in 3 ragged folds,
  10 epochs): identical ``fold_assignments.csv``, equal artifact names
  and result keys, and a mean full-observation ROC-AUC within one fold-std
  of the JAX run with the port's own draws; fed the JAX package's own init
  and draws (6 epochs: rounding drift compounds over steps, and isotonic
  calibration turns it into steps of whole tie groups), every fold's
  metrics within 1e-3 of the JAX run's (two subjects within rounding of
  each other may swap order; one swap moves ROC-AUC by
  1/(n_pos * n_neg), about 1e-3 on a fold of 67);
- the engine against the port's fold-by-fold path (``parallel_cv:
  false``) on equal folds: 2e-3, the CPU tolerance of
  ``tests/test_cv_extras.py:330``;
- the CLI's ``run --model ... --k-fold``, ``train`` and ``evaluate``.
"""
import numpy as np
import pandas as pd
import pytest
import yaml

from pd_fusion.experiments import run_experiment as JR
from pd_fusion_torch import cli
from pd_fusion_torch.data.ppmi_loader import generate_synthetic_data
from pd_fusion_torch.experiments import run_experiment as TR
from pd_fusion_torch.paths import ROOT_DIR
from pd_fusion_torch.utils.seed import set_seed
from test_torch_port_jax_draws import one_cpu_thread, use_jax_draws

QUICKSTART = "configs/quickstart.yaml"
SMALL = {"hidden_dims": [12, 6], "dropout": 0.2, "lr": 0.03, "batch_size": 32, "epochs": 10,
         "moddrop_rate": 0.3}
SEAM = dict(SMALL, lr=0.02, epochs=6)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("PD_FUSION_TORCH_DEVICE", "cpu")
    # both packages on their host-isotonic arm (the device arms are held
    # in test_torch_port_calibrated_cv.py)
    monkeypatch.setenv("PD_FUSION_HOST_ISOTONIC", "1")
    with one_cpu_thread():
        yield


def _frame(n=200):
    set_seed(5)
    return generate_synthetic_data({"num_samples": n, "clinical_dim": 6, "datspect_dim": 4,
                                    "mri_dim": 8, "missing_rates": [0.1, 0.3, 0.4]})


def _files(d):
    return sorted(p.name for p in d.iterdir())


def _fold_results(d, k):
    return [yaml.safe_load((d / f"results_fold_{i}.yaml").read_text()) for i in range(1, k + 1)]


CASES = {
    "fusion_late": {"model_type": "fusion_late"},
    "fusion_masked": {"model_type": "fusion_masked"},
    "fusion_moddrop": {"model_type": "fusion_moddrop"},
    "unimodal_mlp": {"model_type": "unimodal_mlp", "modality": "clinical"},
    "fusion_masked-calibrated": {"model_type": "fusion_masked", "calibrate": True},
    "fusion_moddrop-calibrated": {"model_type": "fusion_moddrop", "calibrate": True},
    "fusion_late-nested": {"model_type": "fusion_late", "calibrate": True,
                           "nested_calibration": True, "calibration_split": 0.25},
    "fusion_moddrop-per-sample-nested": {
        "model_type": "fusion_moddrop", "calibrate": True, "nested_calibration": True,
        "calibration_split": 0.25, "moddrop_per_sample": True},
}


def _overrides(case, params, out):
    case = dict(CASES[case])
    per_sample = case.pop("moddrop_per_sample", False)
    return {"params": dict(params, moddrop_per_sample=per_sample), "cv_plot_example": True,
            "output_dir": str(out), **case}


@pytest.mark.parametrize("case", list(CASES))
def test_cv_run_matches_the_jax_run(monkeypatch, tmp_path, case):
    df, masks = _frame()
    for mod in (JR, TR):
        monkeypatch.setattr(mod, "load_dataset", lambda c, d, s: ("ppmi", df, masks))
    k = 3
    runs = {}
    for name, mod, params in (("jax", JR, SMALL), ("own", TR, SMALL), ("jax_seam", JR, SEAM)):
        agg = mod.run_cv_pipeline(QUICKSTART, k=k, synthetic=True,
                                  overrides=_overrides(case, params, tmp_path / name))
        runs[name] = (tmp_path / name, agg)
    use_jax_draws(monkeypatch)
    TR.run_cv_pipeline(QUICKSTART, k=k, synthetic=True,
                       overrides=_overrides(case, SEAM, tmp_path / "seam"))

    (jdir, jagg), (tdir, tagg) = runs["jax"], runs["own"]
    assert (pd.read_csv(tdir / "fold_assignments.csv")
            .equals(pd.read_csv(jdir / "fold_assignments.csv")))
    assert _files(tdir) == _files(jdir) == _files(tmp_path / "seam")
    assert tagg.keys() == jagg.keys() and len(tagg) == 6
    assert all(tagg[s].keys() == jagg[s].keys() for s in jagg)
    for i in range(1, k + 1):
        jp = pd.read_csv(jdir / f"preds_fold_{i}_full_observation.csv")
        tp = pd.read_csv(tdir / f"preds_fold_{i}_full_observation.csv")
        assert tp.drop(columns="y_prob").equals(jp.drop(columns="y_prob"))
    t_auc = tagg["full_observation"]["roc_auc"]
    j_auc = jagg["full_observation"]["roc_auc"]
    assert np.isfinite(t_auc["mean"])
    assert abs(t_auc["mean"] - j_auc["mean"]) <= max(j_auc["std"], t_auc["std"]), (t_auc, j_auc)

    for jf, sf in zip(_fold_results(tmp_path / "jax_seam", k), _fold_results(tmp_path / "seam", k)):
        for scen in jf:
            if scen != "fold":
                for metric, v in jf[scen].items():
                    assert sf[scen][metric] == pytest.approx(v, abs=1e-3), (scen, metric)


@pytest.mark.parametrize(
    "overrides",
    [{"model_type": "fusion_late", "calibrate": True, "nested_calibration": True,
      "calibration_split": 0.25},
     {"model_type": "fusion_moddrop"}],
    ids=["fusion_late-calibrated-nested", "fusion_moddrop"],
)
def test_engine_matches_the_fold_by_fold_path_on_equal_folds(tmp_path, overrides):
    """k=5 divides the quickstart's N=500: every fold trains on 400 rows,
    so the engine's padded width is each fold's own and both paths use the
    same generators and draws per fold."""
    base = {"params": {"hidden_dims": [16], "dropout": 0.0, "lr": 0.005, "batch_size": 32,
                       "epochs": 8, "moddrop_rate": 0.2}, **overrides}
    folds = {}
    for mode, flag in (("par", True), ("seq", False)):
        TR.run_cv_pipeline(QUICKSTART, k=5, synthetic=True,
                           overrides={**base, "output_dir": str(tmp_path / mode),
                                      "parallel_cv": flag})
        folds[mode] = _fold_results(tmp_path / mode, 5)
    for i in range(5):
        pf, sf = folds["par"][i], folds["seq"][i]
        for scen in ("full_observation", "no_mri", "clinical_only", "random_1_drop"):
            for metric in ("roc_auc", "ece", "brier_score", "pr_auc"):
                assert pf[scen][metric] == pytest.approx(sf[scen][metric], abs=2e-3), (
                    i, scen, metric)


def _small_config(tmp_path, n=150):
    data_cfg = yaml.safe_load((ROOT_DIR / "configs/data_ppmi.yaml").read_text())
    data_cfg["synthetic"]["num_samples"] = n
    (tmp_path / "data.yaml").write_text(yaml.safe_dump(data_cfg))
    cfg = yaml.safe_load((ROOT_DIR / QUICKSTART).read_text())
    cfg["data_config"] = str(tmp_path / "data.yaml")
    (tmp_path / "quick.yaml").write_text(yaml.safe_dump(cfg))
    return tmp_path / "quick.yaml"


def test_cli_runs_moddrop_cv_unimodal_train_and_evaluate(tmp_path, monkeypatch):
    config = str(_small_config(tmp_path))
    agg = cli.main(["run", "--config", config, "--synthetic", "--k-fold", "3", "--model",
                    "fusion_moddrop", "--output-dir", str(tmp_path / "cv")])
    assert len(agg) == 6 and np.isfinite(agg["full_observation"]["roc_auc"]["mean"])
    resolved = yaml.safe_load((tmp_path / "cv" / "resolved_config.yaml").read_text())
    assert resolved["model_type"] == "fusion_moddrop"
    assert resolved["params"]["hidden_dims"] == [64, 32]  # configs/model_fusion.yaml
    assert {f"preds_fold_{i}_full_observation.csv" for i in (1, 2, 3)} <= set(_files(tmp_path / "cv"))

    res = cli.main(["run", "--config", config, "--synthetic", "--model", "unimodal_clinical_mlp",
                    "--output-dir", str(tmp_path / "uni")])
    assert len(res) == 6
    resolved = yaml.safe_load((tmp_path / "uni" / "resolved_config.yaml").read_text())
    assert (resolved["model_type"], resolved["modality"]) == ("unimodal_mlp", "clinical")

    # train: the single-split pipeline under a timestamped run id in runs/
    made = []
    monkeypatch.setattr(TR, "get_run_dir", lambda run_id: made.append(run_id) or tmp_path / run_id)
    (tmp_path / "train").mkdir()
    monkeypatch.setattr(TR, "_run_id", lambda o, p: "train")
    cli.main(["train", "--config", config, "--synthetic"])
    assert made == ["train"] and "model.pt" in _files(tmp_path / "train")

    again = cli.main(["evaluate", "--config", str(ROOT_DIR / "configs/eval_missingness.yaml"),
                      "--run-dir", str(tmp_path / "uni")])
    for scen in ("full_observation", "no_dat", "no_mri", "clinical_only"):
        for metric, v in res[scen].items():
            assert again[scen][metric] == pytest.approx(v, abs=1e-6), (scen, metric)
