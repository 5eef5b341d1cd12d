"""The ds001907 MIL-attention CV slice of the port, end to end on the CPU,
against the JAX package's run of the same frame.

- folds, calibration splits, isotonic calibration and the curves behind
  the plots: the port's numpy copies against scikit-learn as the JAX
  package calls it, bit for bit (splits) or to 1e-12 (f64 curves);
- the CV tail fed the same kept-bag probabilities: 1e-6 absolute (f32
  metric sums taken in another order);
- whole runs of ``run_cv_pipeline``: identical fold CSV, artifact names
  and result keys; the mean full-observation ROC-AUC within 0.1 (the two
  packages draw init, shuffles and dropout from different generators);
- the port's CLI through the real ds001907 loader on a tiny ``.npz``.
"""
import warnings

import numpy as np
import pandas as pd
import pytest
import yaml

from pd_fusion.data import splits as JS
from pd_fusion.experiments import run_experiment as JR
from pd_fusion.parallel import cv_engine as JC
from pd_fusion_torch.data import splits as TS
from pd_fusion_torch.evaluation import plots as TP
from pd_fusion_torch.experiments import run_experiment as TR
from pd_fusion_torch.models.calibrate import IsotonicRegression
from pd_fusion_torch.parallel import cv_engine as TC
from test_torch_port_jax_draws import one_cpu_thread

MIL_CONFIG = "configs/openneuro_ds001907_resnet2d_mil.yaml"
SMALL_PARAMS = {
    "hidden_dim": 16, "attn_dim": 8, "dropout": 0.2, "gated": True,
    "class_weight": "balanced", "lr": 0.01, "batch_size": 8, "epochs": 8,
    "early_stopping_patience": 3, "max_grad_norm": 1.0, "weight_decay": 0.001,
    "missing_prob": 0.5,
}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("PD_FUSION_TORCH_DEVICE", "cpu")
    with one_cpu_thread():
        yield


def _bag_frame(n_subjects=40, dim=12, seed=0, n_missing=2):
    """Two sessions per subject, one label per subject; positive bags carry
    a few shifted instances; ``n_missing`` rows have no bag."""
    rng = np.random.RandomState(seed)
    y_subj = rng.permutation(np.repeat([0, 1], n_subjects // 2))
    rows = []
    for s in range(n_subjects):
        for session in (1, 2):
            bag = rng.randn(rng.randint(5, 13), dim).astype(np.float32)
            if y_subj[s]:
                bag[rng.choice(len(bag), 2, replace=False)] += 3.0
            rows.append((f"sub-{s:03d}", session, int(y_subj[s]), bag))
    df = pd.DataFrame(rows, columns=["subject_id", "session", "diagnosis", "mri_mil"])
    for j in rng.choice(len(df), n_missing, replace=False):
        df.at[j, "mri_mil"] = None
    mri = df["mri_mil"].map(lambda b: int(b is not None)).to_numpy()
    zeros = np.zeros(len(df), int)
    return df, {"clinical": zeros, "datspect": zeros.copy(), "mri": mri}


# ---------------------------------------------------------------------------
# numpy copies of scikit-learn
# ---------------------------------------------------------------------------


def _positions(df, parts):
    return [[df.index.get_indexer(p.index).tolist() for p in part] for part in parts]


def _uneven_group_frame(seed, n_subjects=60):
    """1-3 sessions per subject: group sizes tie often, so the splitter's
    order among equal spreads (a stable sort in scikit-learn) matters."""
    rng = np.random.RandomState(seed)
    rows = [(f"sub-{s:03d}", ses, label)
            for s, label in enumerate(rng.randint(0, 2, n_subjects))
            for ses in range(1, rng.randint(2, 5))]
    return pd.DataFrame(rows, columns=["subject_id", "session", "diagnosis"])


@pytest.mark.parametrize("seed", [0, 42, 7])
@pytest.mark.parametrize("k", [2, 5])
def test_group_and_plain_kfold_are_the_jax_packages(k, seed):
    df = _uneven_group_frame(seed)
    for want, got in (
        (JS.get_group_kfold_splits(df, k, seed, "subject_id"),
         TS.get_group_kfold_splits(df, k, seed, "subject_id")),
        (JS.get_kfold_splits(df, k, seed), TS.get_kfold_splits(df, k, seed)),
    ):
        assert _positions(df, got) == _positions(df, want)


@pytest.mark.parametrize("group_col", [None, "subject_id"], ids=["stratified", "grouped"])
@pytest.mark.parametrize("calib_size", [0.1, 0.25])
def test_calibration_and_holdout_splits_are_the_jax_packages(calib_size, group_col):
    df = _uneven_group_frame(seed=3)
    for seed in (0, 42):
        want = JS.split_train_calibration(df, calib_size, seed, group_col)
        got = TS.split_train_calibration(df, calib_size, seed, group_col)
        assert _positions(df, [got]) == _positions(df, [want])
        want = JS.stratified_split(df, seed=seed)
        got = TS.stratified_split(df, seed=seed)
        assert _positions(df, [got]) == _positions(df, [want])


@pytest.mark.parametrize("kind", ["random", "ties", "constant", "one_point"])
def test_isotonic_matches_sklearn(kind):
    from sklearn.isotonic import IsotonicRegression as SkIsotonic

    rng = np.random.RandomState(len(kind))
    n = {"one_point": 1}.get(kind, 40)
    x = rng.rand(n).astype(np.float32)
    if kind == "ties":
        x = (rng.randint(0, 5, n) / 5).astype(np.float32)
    elif kind == "constant":
        x = np.full(n, 0.5, np.float32)
    y = rng.randint(0, 2, n).astype(np.float32)
    t = np.concatenate([rng.rand(30), [-0.5, 0.0, 1.0, 1.5]]).astype(np.float32)
    want = SkIsotonic(out_of_bounds="clip").fit(x, y).transform(t)
    got = IsotonicRegression().fit(x, y).transform(t)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["random", "ties", "single_class"])
def test_curves_behind_the_plots_match_sklearn(kind):
    from sklearn.calibration import calibration_curve
    from sklearn.metrics import precision_recall_curve, roc_curve

    rng = np.random.RandomState(1)
    y = rng.randint(0, 2, 50)
    p = rng.rand(50).astype(np.float32)
    if kind == "ties":
        p = (rng.randint(0, 6, 50) / 5).astype(np.float32)
    elif kind == "single_class":
        y = np.ones(50, int)
    with warnings.catch_warnings():  # single-class input: sklearn warns, both give NaN
        warnings.simplefilter("ignore")
        pairs = [(roc_curve(y, p), TP.roc_curve(y, p)),
                 (precision_recall_curve(y, p), TP.precision_recall_curve(y, p)),
                 (calibration_curve(y, p, n_bins=10), TP.calibration_curve(y, p, 10))]
    for want, got in pairs:
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# the CV tail on the same kept-bag probabilities
# ---------------------------------------------------------------------------


def _tail_inputs(k=2, seed=5):
    df, masks = _bag_frame(n_subjects=24, seed=seed, n_missing=3)
    folds = list(TS.get_group_kfold_splits(df, k, 42, "subject_id"))
    rng = np.random.RandomState(seed)
    fold_rows = []
    for train_df, val_df in folds:
        _, cal_df = TS.split_train_calibration(train_df, 0.25, 42, "subject_id")
        cal_masks = TS.get_subset_masks(masks, cal_df.index)
        keep = lambda f: [j for j, b in enumerate(f["mri_mil"].tolist()) if b is not None]
        fold_rows.append({
            "y_va": val_df["diagnosis"].values.astype(np.float32), "keep_va": keep(val_df),
            "val_df": val_df, "val_masks": TS.get_subset_masks(masks, val_df.index),
            "y_cal": cal_df["diagnosis"].values.astype(np.float32), "keep_cal": keep(cal_df),
            "cal_mri": cal_masks["mri"],
        })
    nv_w = max(len(r["keep_va"]) for r in fold_rows)
    nc_w = max(len(r["keep_cal"]) for r in fold_rows)
    kept = rng.rand(k, nv_w + nc_w).astype(np.float32)
    kept[:, ::7] = 0.5  # ties with the missing-bag constant
    eval_cfg = TR.ROOT_DIR / "configs/eval_missingness_openneuro_ds001907.yaml"
    return fold_rows, kept, nv_w, yaml.safe_load(eval_cfg.read_text())["scenarios"]


def _run_tail(engine, to_array, from_array, isotonic, unpack):
    fold_rows, kept, nv_w, scenarios = _tail_inputs()
    np.random.seed(11)  # the random-drop scenarios draw from numpy's global RNG
    probs, yv, wv, nv_max = engine._assemble_mil_scenario_probs(
        fold_rows, kept[:, :nv_w], scenarios, 0.5)
    for i, r in enumerate(fold_rows):
        vec = np.full(len(r["y_cal"]), 0.5, np.float32)
        for slot, row in enumerate(r["keep_cal"]):
            if r["cal_mri"][row] != 0:
                vec[row] = kept[i, nv_w + slot]
        iso = isotonic().fit(vec, r["y_cal"])
        probs[i] = iso.transform(probs[i].ravel()).reshape(probs[i].shape)
    packed = from_array(engine._metrics_from_probs_packed(
        to_array(probs), to_array(yv), to_array(wv)))
    K, S = probs.shape[:2]
    return unpack(packed, (K, S), (K, S, nv_max))


def test_cv_tail_matches_jax_on_the_same_kept_probs():
    import jax.numpy as jnp
    import torch
    from sklearn.isotonic import IsotonicRegression as SkIsotonic

    from pd_fusion.ops.metrics import unpack_metrics_and_probs as j_unpack
    from pd_fusion_torch.ops.metrics import unpack_metrics_and_probs as t_unpack

    md_j, probs_j = _run_tail(JC, jnp.asarray, np.asarray,
                              lambda: SkIsotonic(out_of_bounds="clip"), j_unpack)
    md_t, probs_t = _run_tail(TC, torch.as_tensor, lambda t: t.numpy(), IsotonicRegression,
                              t_unpack)
    np.testing.assert_array_equal(probs_t, probs_j)
    assert md_t.keys() == md_j.keys()
    for k in md_j:
        np.testing.assert_allclose(md_t[k], md_j[k], atol=1e-6, rtol=0, err_msg=k)
    assert np.isfinite(md_t["roc_auc"]).all()


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------


def _run_both(monkeypatch, tmp_path, df, masks, k=2, parallel_cv=True):
    for mod in (JR, TR):
        monkeypatch.setattr(mod, "load_dataset", lambda c, d, s: ("openneuro_ds001907", df, masks))
    out = {}
    for name, mod in (("jax", JR), ("torch", TR)):
        run_dir = tmp_path / name
        agg = mod.run_cv_pipeline(MIL_CONFIG, k=k, overrides={
            "output_dir": str(run_dir), "params": dict(SMALL_PARAMS),
            "parallel_cv": parallel_cv})
        out[name] = (run_dir, agg)
    return out


@pytest.mark.parametrize("parallel_cv", [True, False], ids=["cv-engine", "fold-by-fold"])
def test_cv_slice_matches_jax_run(monkeypatch, tmp_path, parallel_cv):
    df, masks = _bag_frame()
    runs = _run_both(monkeypatch, tmp_path, df, masks, parallel_cv=parallel_cv)
    (jdir, jagg), (tdir, tagg) = runs["jax"], runs["torch"]

    assert (pd.read_csv(tdir / "fold_assignments.csv")
            .equals(pd.read_csv(jdir / "fold_assignments.csv")))
    files = lambda d: sorted(p.name for p in d.iterdir())
    assert files(tdir) == files(jdir)
    assert "roc_curve_fold1.png" in files(tdir) and "results_fold_2.yaml" in files(tdir)
    for i in (1, 2):
        jf = yaml.safe_load((jdir / f"results_fold_{i}.yaml").read_text())
        tf = yaml.safe_load((tdir / f"results_fold_{i}.yaml").read_text())
        assert tf.keys() == jf.keys()
        for scen in jf:
            if scen != "fold":
                assert tf[scen].keys() == jf[scen].keys()
        jp = pd.read_csv(jdir / f"preds_fold_{i}_full_observation.csv")
        tp = pd.read_csv(tdir / f"preds_fold_{i}_full_observation.csv")
        assert list(tp.columns) == list(jp.columns)
        assert tp.drop(columns="y_prob").equals(jp.drop(columns="y_prob"))
    assert tagg.keys() == jagg.keys() and len(tagg) == 7
    t_auc = tagg["full_observation"]["roc_auc"]["mean"]
    j_auc = jagg["full_observation"]["roc_auc"]["mean"]
    assert np.isfinite(t_auc) and abs(t_auc - j_auc) <= 0.1, (t_auc, j_auc)
    # dropping every bag leaves only the constant: chance in both
    assert tagg["mri_missing_100"]["roc_auc"]["mean"] == jagg["mri_missing_100"]["roc_auc"]["mean"]
    prov = yaml.safe_load((tdir / "provenance.yaml").read_text())
    assert prov["env"]["device"] == "cpu" and "torch" in prov["env"]


def _write_ds001907(tmp_path, n_subjects=12, n_slices=6, dim=8):
    """A tiny ds001907 ``.npz`` under the loader's content-addressed name,
    its manifest, and copies of the repo's MIL configs that change only
    the data paths (and shrink the head so the CPU run is quick)."""
    from pd_fusion_torch.data.openneuro_features import _cache_stem
    from pd_fusion_torch.paths import ROOT_DIR

    cfg = yaml.safe_load((ROOT_DIR / MIL_CONFIG).read_text())
    data_cfg = yaml.safe_load((ROOT_DIR / cfg["data_config"]).read_text())
    manifest, cache = tmp_path / "manifest.csv", tmp_path / "emb"
    cache.mkdir()
    data_cfg.update(manifest_path=str(manifest), resnet2d_cache_dir=str(cache))
    (tmp_path / "data.yaml").write_text(yaml.safe_dump(data_cfg))
    cfg.update(data_config=str(tmp_path / "data.yaml"), params=dict(SMALL_PARAMS, epochs=3),
               calibration_split=0.25)
    (tmp_path / "mil.yaml").write_text(yaml.safe_dump(cfg))

    rng = np.random.RandomState(0)
    y = rng.permutation(np.repeat([0, 1], n_subjects // 2))
    sub = [f"sub-{s:02d}" for s in range(n_subjects) for _ in (1, 2)]
    ses = [ses for _ in range(n_subjects) for ses in (1, 2)]
    lab = [int(y[s]) for s in range(n_subjects) for _ in (1, 2)]
    emb = rng.randn(len(sub), n_slices, dim).astype(np.float32)
    emb[np.asarray(lab) == 1, :2] += 2.0
    manifest.write_text("subject_id,session,label\n"
                        + "".join(f"{a},{b},{c}\n" for a, b, c in zip(sub, ses, lab)))
    stem = _cache_stem("resnet2d_mil", manifest, data_cfg["resnet2d_config"])
    np.savez(cache / f"{stem}.npz", embeddings=emb, subject_id=np.array(sub),
             session=np.array(ses), label=np.array(lab))
    return tmp_path / "mil.yaml"


def test_cli_runs_the_real_ds001907_loader(tmp_path):
    from pd_fusion.data.openneuro_features import _cache_stem as jax_cache_stem
    from pd_fusion_torch import cli
    from pd_fusion_torch.data.openneuro_features import _cache_stem

    config = _write_ds001907(tmp_path)
    data_cfg = yaml.safe_load((tmp_path / "data.yaml").read_text())
    args = ("resnet2d_mil", tmp_path / "manifest.csv", data_cfg["resnet2d_config"])
    assert _cache_stem(*args) == jax_cache_stem(*args)  # the loader finds the JAX package's files

    out = tmp_path / "run"
    agg = cli.main(["run", "--config", str(config), "--k-fold", "2", "--output-dir", str(out)])
    assert len(agg) == 7 and np.isfinite(agg["full_observation"]["roc_auc"]["mean"])
    assert {f"results_fold_{i}.yaml" for i in (1, 2)} <= {p.name for p in out.iterdir()}
    fa = pd.read_csv(out / "fold_assignments.csv")
    assert (fa.groupby("subject_id")["fold"].nunique() == 1).all()


def test_cli_reads_cv_folds_from_config_as_given(monkeypatch, tmp_path):
    """As in the JAX CLI, ``cv_folds`` is read from ``Path(--config)`` with no
    repo-root fallback: a relative path from another directory runs the
    single-split pipeline."""
    from pd_fusion_torch import cli
    from pd_fusion_torch.paths import ROOT_DIR

    calls = []
    monkeypatch.setattr(TR, "run_cv_pipeline", lambda path, k, **kw: calls.append(("cv", k)))
    monkeypatch.setattr(TR, "run_full_pipeline", lambda path, *a, **kw: calls.append(("full",)))
    monkeypatch.chdir(tmp_path)
    cli.main(["run", "--config", MIL_CONFIG])
    cli.main(["run", "--config", str(ROOT_DIR / MIL_CONFIG)])
    cli.main(["run", "--config", MIL_CONFIG, "--k-fold", "3"])
    assert calls == [("full",), ("cv", 5), ("cv", 3)]


def test_cli_refuses_what_is_not_ported():
    from pd_fusion_torch import cli

    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 14"):
        cli.main(["validate-data", "--config", "configs/data_ppmi.yaml"])
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 11"):
        cli.main(["run", "--config", MIL_CONFIG, "--model", "mil_attention_ft"])
    with pytest.raises(NotImplementedError, match="item 14"):
        cli.main(["run", "--config", MIL_CONFIG, "--dataset", "uci_parkinsons"])
