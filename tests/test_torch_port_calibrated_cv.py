"""Whole CV runs of the calibrated MLP, MoE and GBDT paths through the
port's CV engine and CLI, against the port's fold-by-fold path
(``parallel_cv: false``) and against the JAX package's runs.

Tolerances, per fold, on full_observation, no_mri and clinical_only
(ROC-AUC, ECE, Brier):
- calibrated ``fusion_moddrop`` and ``moe``, nested and not: the device
  isotonic arm against the host arm (``PD_FUSION_HOST_ISOTONIC=1``) on the
  same trained folds within 2e-3, the CPU tolerance of
  ``tests/test_cv_extras.py:330`` (measured: equal); the engine against
  the fold-by-fold path (host isotonic through the calibration wrapper)
  within 2e-3 nested, and within 5e-3 when the val fold is also the
  calibration set, the band ``tests/test_device_gbdt.py:585`` gives
  calibrated GBDT for the same reason: there the fit transforms the very
  probs it saw, so one subject whose probability differs by an ulp
  between the fold-batched and the single-model trainer lands on or one
  ulp off an isotonic knot, and ROC-AUC steps by a tie group (measured
  2.7e-3 on fold 4 of ``fusion_moddrop``);
- ``moe`` fed the JAX package's init (``use_jax_draws``): every metric of
  every fold within 1e-3 of the JAX run (a swap of two near-tied subjects
  moves ROC-AUC by about 1e-3 on a fold of 100), after 5 epochs: rounding
  drift compounds over steps, and calibration on the val fold turns it
  into whole tie groups (after 15 epochs the val-calibrated run measured
  up to 9.5e-3 on one fold's ROC-AUC; the uncalibrated and nested ones
  stay within 1e-3);
- device-backend ``unimodal_gbdt``: the engine against the fold-by-fold
  path within 1e-5, calibrated 5e-3 (``tests/test_device_gbdt.py:585``);
  against the JAX run of the same frame, the mean full-observation ROC-AUC
  within one fold-std;
- the CLI commands write the JAX run's artifact names and result keys.
"""
import sys

import numpy as np
import pandas as pd
import pytest
import yaml

from pd_fusion.experiments import run_experiment as JR
from pd_fusion_torch import cli
from pd_fusion_torch.experiments import run_experiment as TR
from pd_fusion_torch.parallel import cv_engine
from pd_fusion_torch.paths import ROOT_DIR
from test_torch_port_jax_draws import one_cpu_thread, use_jax_draws

QUICKSTART = "configs/quickstart.yaml"
SCENS = ("full_observation", "no_mri", "clinical_only")
METRICS = ("roc_auc", "ece", "brier_score")
MLP = {"hidden_dims": [16], "dropout": 0.0, "lr": 0.005, "batch_size": 32, "epochs": 20,
       "moddrop_rate": 0.2}
MOE = {"expert_hidden_dims": [16], "router_hidden_dims": [8], "lr": 0.005, "epochs": 15}
SEAM_MOE = dict(MOE, epochs=5)
GBDT = {"backend": "device", "n_estimators": 30, "learning_rate": 0.2, "max_depth": 4}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("PD_FUSION_TORCH_DEVICE", "cpu")
    for var in ("PD_FUSION_HOST_ISOTONIC", "PD_FUSION_GBDT_BACKEND", "PD_FUSION_GBDT_HIST"):
        monkeypatch.delenv(var, raising=False)
    with one_cpu_thread():
        yield


def _fold_results(d, k=5):
    return [yaml.safe_load((d / f"results_fold_{i}.yaml").read_text()) for i in range(1, k + 1)]


def _run(mod, tmp_path, name, overrides, k=5):
    mod.run_cv_pipeline(QUICKSTART, k=k, synthetic=True,
                        overrides={**overrides, "output_dir": str(tmp_path / name)})
    return _fold_results(tmp_path / name, k)


def _assert_folds_close(a, b, tol, scens=SCENS, metrics=METRICS):
    for i, (fa, fb) in enumerate(zip(a, b)):
        for scen in scens:
            for metric in metrics:
                assert fa[scen][metric] == pytest.approx(fb[scen][metric], abs=tol), (
                    i, scen, metric, fa[scen][metric], fb[scen][metric])


def _calibrated(model_type, params, nested):
    return {"model_type": model_type, "params": params, "calibrate": True,
            "nested_calibration": nested, "calibration_split": 0.25}


@pytest.mark.parametrize("nested", [False, True], ids=["val-calibrated", "nested"])
@pytest.mark.parametrize("model_type,params", [("fusion_moddrop", MLP), ("moe", MOE)],
                         ids=["fusion_moddrop", "moe"])
def test_calibrated_engine_matches_the_fold_by_fold_path(monkeypatch, tmp_path, model_type,
                                                          params, nested):
    """k=5 divides N=500: every fold trains on 400 rows, so the engine's
    padded width is each fold's own."""
    base = _calibrated(model_type, params, nested)
    before = dict(cv_engine.isotonic_arms)
    par = _run(TR, tmp_path, "par", base)
    assert cv_engine.isotonic_arms["device"] == before["device"] + 1
    seq = _run(TR, tmp_path, "seq", {**base, "parallel_cv": False})
    _assert_folds_close(par, seq, 2e-3 if nested else 5e-3)
    monkeypatch.setenv("PD_FUSION_HOST_ISOTONIC", "1")
    host = _run(TR, tmp_path, "host", base)
    assert cv_engine.isotonic_arms["host"] == before["host"] + 1
    _assert_folds_close(par, host, 2e-3)


@pytest.mark.parametrize("case", ["plain", "calibrated", "nested"])
def test_moe_cv_fed_the_jax_init_gives_the_jax_runs_metrics(monkeypatch, tmp_path, case):
    overrides = {"model_type": "moe", "params": SEAM_MOE} if case == "plain" else _calibrated(
        "moe", SEAM_MOE, case == "nested")
    want = _run(JR, tmp_path, "jax", overrides)
    use_jax_draws(monkeypatch)
    got = _run(TR, tmp_path, "port", overrides)
    for jf, tf in zip(want, got):
        assert jf.keys() == tf.keys()
        for scen in jf:
            if scen != "fold":
                for metric, v in jf[scen].items():
                    assert tf[scen][metric] == pytest.approx(v, abs=1e-3), (scen, metric)


@pytest.mark.parametrize("calibrate", [False, True], ids=["plain", "calibrated"])
def test_gbdt_engine_matches_the_fold_by_fold_path(tmp_path, calibrate):
    base = {"model_type": "unimodal_gbdt", "modality": "clinical", "calibrate": calibrate,
            "params": GBDT}
    par = _run(TR, tmp_path, "par", base)
    seq = _run(TR, tmp_path, "seq", {**base, "parallel_cv": False})
    _assert_folds_close(par, seq, 5e-3 if calibrate else 1e-5,
                        scens=("full_observation", "clinical_only", "random_1_drop"))


@pytest.mark.parametrize("calibrate", [False, True], ids=["plain", "calibrated"])
def test_gbdt_cv_is_within_a_fold_std_of_the_jax_run(monkeypatch, tmp_path, calibrate):
    """Both packages on their device trainers (the JAX one off its test
    mesh), the same frame and folds."""
    monkeypatch.setenv("PD_FUSION_GBDT_BACKEND", "device")
    base = {"model_type": "unimodal_gbdt", "modality": "clinical", "calibrate": calibrate,
            "cv_mesh": "off", "params": GBDT}
    aggs = {}
    for name, mod in (("jax", JR), ("port", TR)):
        aggs[name] = mod.run_cv_pipeline(QUICKSTART, k=5, synthetic=True,
                                         overrides={**base, "output_dir": str(tmp_path / name)})
    j, t = (aggs[n]["full_observation"]["roc_auc"] for n in ("jax", "port"))
    assert abs(t["mean"] - j["mean"]) <= max(j["std"], t["std"]), (t, j)
    assert pd.read_csv(tmp_path / "port" / "fold_assignments.csv").equals(
        pd.read_csv(tmp_path / "jax" / "fold_assignments.csv"))


# ---------------------------------------------------------------------------
# the CLI commands, against the JAX package's CLI
# ---------------------------------------------------------------------------


def _small_config(tmp_path, **extra):
    data_cfg = yaml.safe_load((ROOT_DIR / "configs/data_ppmi.yaml").read_text())
    data_cfg["synthetic"]["num_samples"] = 150
    (tmp_path / "data.yaml").write_text(yaml.safe_dump(data_cfg))
    cfg = yaml.safe_load((ROOT_DIR / QUICKSTART).read_text())
    cfg.update(data_config=str(tmp_path / "data.yaml"), **extra)
    (tmp_path / "quick.yaml").write_text(yaml.safe_dump(cfg))
    return str(tmp_path / "quick.yaml")


def _files(d):
    return sorted(p.name for p in d.iterdir())


def _jax_cli(monkeypatch, args):
    from pd_fusion import cli as jax_cli

    monkeypatch.setattr(sys, "argv", ["pd_fusion"] + args)
    jax_cli.main()


CLI_CASES = {
    "cv5-fusion_moddrop-calibrated": (["--k-fold", "5", "--model", "fusion_moddrop"],
                                      {"calibrate": True}),
    "cv5-fusion_moddrop-nested": (["--k-fold", "5", "--model", "fusion_moddrop"],
                                  {"calibrate": True, "nested_calibration": True}),
    "cv5-moe": (["--k-fold", "5", "--model", "moe"], {}),
    "cv5-moe-calibrated": (["--k-fold", "5", "--model", "moe"], {"calibrate": True}),
    "cv5-unimodal_clinical": (["--k-fold", "5", "--model", "unimodal_clinical"], {}),
    "cv5-unimodal_clinical-calibrated": (["--k-fold", "5", "--model", "unimodal_clinical"],
                                         {"calibrate": True}),
    "single-moe": (["--model", "moe"], {}),
    "single-unimodal_clinical": (["--model", "unimodal_clinical"], {}),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_command_writes_the_jax_runs_artifacts(monkeypatch, tmp_path, case):
    """``unimodal_clinical`` resolves to ``unimodal_gbdt`` with
    ``configs/model_unimodal.yaml`` (100 trees, depth 5); on the CPU both
    packages take the host backend, so those metrics agree exactly."""
    args, extra = CLI_CASES[case]
    config = _small_config(tmp_path, **extra)
    outs = {n: tmp_path / n for n in ("jax", "port")}
    common = ["run", "--config", config, "--synthetic"] + args
    _jax_cli(monkeypatch, common + ["--output-dir", str(outs["jax"])])
    cli.main(common + ["--output-dir", str(outs["port"])])
    assert _files(outs["port"]) == _files(outs["jax"])
    resolved = {n: yaml.safe_load((d / "resolved_config.yaml").read_text()) for n, d in outs.items()}
    assert resolved["port"]["model_type"] == resolved["jax"]["model_type"]
    assert resolved["port"]["params"] == resolved["jax"]["params"]
    name = "results_aggregated.yaml" if "--k-fold" in args else "results.yaml"
    res = {n: yaml.safe_load((d / name).read_text()) for n, d in outs.items()}
    assert res["port"].keys() == res["jax"].keys() and len(res["port"]) == 6
    for scen in res["jax"]:
        assert res["port"][scen].keys() == res["jax"][scen].keys()
    if "unimodal" in case:
        for scen in res["jax"]:
            for metric, v in res["jax"][scen].items():
                assert res["port"][scen][metric] == pytest.approx(v, abs=1e-6)
    if "--k-fold" not in args:
        again = cli.main(["evaluate", "--config", str(ROOT_DIR / "configs/eval_missingness.yaml"),
                          "--run-dir", str(outs["port"])])
        for scen in ("full_observation", "no_dat", "no_mri", "clinical_only"):
            for metric, v in res["port"][scen].items():
                assert again[scen][metric] == pytest.approx(v, abs=1e-6), (scen, metric)
