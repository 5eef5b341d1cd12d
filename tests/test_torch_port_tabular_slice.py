"""The tabular slice of the port, on the CPU, against the JAX package: the
flat-feature model families, the fused scenario evaluation, the CV
engine's tail fed JAX-trained params, and whole single-split runs.

Tolerances: a model reloaded from its artifact predicts bit for bit; the
fused and per-scenario evaluations agree to 1e-6 (f32 sums in another
order); the CV tail fed the same trained params gives JAX's metrics and
probabilities to 1e-6; a whole run fed the JAX package's own init and
draws (``test_torch_port_jax_draws.use_jax_draws``) gives the JAX run's
metrics to 1e-3: its probabilities differ by rounding, so two test
subjects within rounding of each other may swap order (one swap moves
ROC-AUC by 1/(n_pos * n_neg), about 2e-4 on the quickstart's 100).
"""
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from pd_fusion.experiments import run_experiment as JR
from pd_fusion.parallel import cv_engine as JC
from pd_fusion_torch.data.feature_utils import get_modality_feature_cols
from pd_fusion_torch.data.missingness import apply_missingness_scenario
from pd_fusion_torch.data.ppmi_loader import generate_synthetic_data
from pd_fusion_torch.data.schema import MODALITIES, TARGET_COL
from pd_fusion_torch.data.splits import get_subset_masks, stratified_split
from pd_fusion_torch.evaluation.evaluate import evaluate_model, predict_for_masks
from pd_fusion_torch.experiments import run_experiment as TR
from pd_fusion_torch.models.serialization import load_model
from pd_fusion_torch.parallel import cv_engine as TC
from pd_fusion_torch.training.train import train_pipeline
from pd_fusion_torch.utils.metrics import compute_metrics
from pd_fusion_torch.utils.seed import set_seed
from test_torch_port_jax_draws import one_cpu_thread, use_jax_draws

QUICKSTART = "configs/quickstart.yaml"
REF_FULL_OBS_ROC_AUC = 0.7121  # tests/test_parity_reference.py:37, band 0.12
SMALL = {"hidden_dims": [12, 6], "dropout": 0.2, "lr": 0.01, "batch_size": 16, "epochs": 6,
         "moddrop_rate": 0.3}
SCENARIOS = [
    {"name": "full_observation", "drop_modalities": []},
    {"name": "no_mri", "drop_modalities": ["mri"]},
    {"name": "clinical_only", "drop_modalities": ["datspect", "mri"]},
    {"name": "random_1_drop", "n_drop": 1, "type": "random"},
]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("PD_FUSION_TORCH_DEVICE", "cpu")
    with one_cpu_thread():
        yield


def _data(n=150, seed=3, mri_dim=8):
    set_seed(seed)
    return generate_synthetic_data({"num_samples": n, "clinical_dim": 6, "datspect_dim": 4,
                                    "mri_dim": mri_dim, "missing_rates": [0.1, 0.2, 0.3]})


FAMILIES = {
    "fusion_late": {"model_type": "fusion_late"},
    "fusion_masked": {"model_type": "fusion_masked"},
    "fusion_moddrop": {"model_type": "fusion_moddrop"},
    "fusion_moddrop_per_sample": {"model_type": "fusion_moddrop",
                                  "params": dict(SMALL, moddrop_per_sample=True)},
    "unimodal_mlp": {"model_type": "unimodal_mlp", "modality": "datspect"},
    "unimodal_mlp_no_columns": {"model_type": "unimodal_mlp", "modality": "eeg"},
    "fusion_late_calibrated": {"model_type": "fusion_late", "calibrate": True},
}


def _train(family, df, masks):
    config = {"params": dict(SMALL), **FAMILIES[family]}
    tr, va, te = stratified_split(df, seed=0)
    model, prep = train_pipeline(config, tr, va, get_subset_masks(masks, tr.index),
                                 get_subset_masks(masks, va.index))
    return model, prep, te, get_subset_masks(masks, te.index)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_flat_family_trains_predicts_saves_and_reloads(family, tmp_path):
    df, masks = _data()
    model, prep, te, te_masks = _train(family, df, masks)
    p = predict_for_masks(model, te, te_masks, prep)
    assert p.shape == (len(te),) and np.isfinite(p).all()
    if family == "unimodal_mlp_no_columns":
        from pd_fusion_torch.models.dummy import ConstantProbabilityModel

        assert isinstance(model, ConstantProbabilityModel) and prep == (None, None, [])
    elif family == "unimodal_mlp":
        assert prep[2] == get_modality_feature_cols(df, "datspect")
        assert prep[1].medians.shape == (4,)  # fitted on the modality's own columns
    else:
        assert len(np.unique(p)) > 1
    model.save(tmp_path / "model.pt")
    again = load_model(tmp_path / "model.pt")
    assert type(again) is type(model)
    np.testing.assert_array_equal(predict_for_masks(again, te, te_masks, prep), p)
    if family == "fusion_masked":
        assert again.mask_dim == 3
    res = evaluate_model(model, te, te_masks, prep, {"scenarios": SCENARIOS})
    assert list(res) == [s["name"] for s in SCENARIOS]


def _loop_results(model, df, masks, prep_info):
    out, y_true = {}, df[TARGET_COL].values
    for scenario in SCENARIOS:
        cm = apply_missingness_scenario(df, scenario, masks)
        out[scenario["name"]] = compute_metrics(y_true, predict_for_masks(model, df, cm, prep_info))
    return out


@pytest.mark.parametrize("family", ["fusion_late", "fusion_masked", "fusion_moddrop"])
def test_fused_and_per_scenario_evaluation_agree(family):
    df, masks = _data()
    model, prep, te, te_masks = _train(family, df, masks)
    set_seed(11)  # the random-drop scenario draws must be the same on both paths
    fused = evaluate_model(model, te, te_masks, prep, {"scenarios": SCENARIOS})
    set_seed(11)
    loop = _loop_results(model, te, te_masks, prep)
    assert fused.keys() == loop.keys()
    for scen in fused:
        assert fused[scen].keys() == loop[scen].keys()
        for metric, v in loop[scen].items():
            assert fused[scen][metric] == pytest.approx(v, abs=1e-6), (scen, metric)


# ---------------------------------------------------------------------------
# the CV tail fed the JAX package's trained params
# ---------------------------------------------------------------------------


def _jax_trained_stack(K=3, n=30, nv=12, S=4, F=9, seed=0):
    """JAX-trained fold-stacked params plus stacked eval/calibration inputs."""
    import jax

    rng = np.random.RandomState(seed)
    X = rng.randn(K, n, F).astype(np.float32)
    y = (X[..., 0] - X[..., 1] + 0.5 * rng.randn(K, n) > 0).astype(np.float32)
    w = np.ones((K, n), np.float32)
    w[0, -5:] = 0.0
    keys = jax.random.split(jax.random.PRNGKey(seed), 2 * K)
    p0 = JC._init_folds_mlp(keys[:K], (F, 8, 1))
    trained = JC._train_folds_fullbatch(p0, X, y, w, keys[K:], 0.02, 15, 0.1, 0.0)
    trained = jax.tree_util.tree_map(np.asarray, trained)
    Xs = rng.randn(K, S, nv, F).astype(np.float32)
    Xs[:, :, ::4] = 0.0  # tied rows
    yv = np.repeat((rng.rand(K, 1, nv) > 0.5).astype(np.float32), S, axis=1)
    wv = np.ones((K, S, nv), np.float32)
    wv[1, :, -3:] = 0.0  # a shorter fold
    Xc = rng.randn(K, 10, F).astype(np.float32)
    yc = [(rng.rand(10) > 0.5).astype(np.float32) for _ in range(K)]
    return trained, Xs, yv, wv, Xc, yc


def test_cv_tail_matches_jax_packed_mlp_eval_on_jax_trained_params():
    import jax.numpy as jnp

    from pd_fusion.ops.metrics import unpack_metrics_and_probs as j_unpack
    from pd_fusion_torch.nn.mlp import mlp_params_from_jax
    from pd_fusion_torch.ops.metrics import unpack_metrics_and_probs as t_unpack

    trained, Xs, yv, wv, _, _ = _jax_trained_stack()
    K, S, nv = yv.shape
    want = np.asarray(JC._eval_folds_scenarios_packed_mlp(
        trained, jnp.asarray(Xs), jnp.asarray(yv), jnp.asarray(wv)))
    got = TC._packed_mlp_eval(mlp_params_from_jax(trained), torch.from_numpy(Xs),
                              torch.from_numpy(yv), torch.from_numpy(wv)).numpy()
    md_j, pj = j_unpack(want, (K, S), (K, S, nv))
    md_t, pt = t_unpack(got, (K, S), (K, S, nv))
    np.testing.assert_allclose(pt, pj, atol=1e-6, rtol=0)
    for k in md_j:
        np.testing.assert_allclose(md_t[k], md_j[k], atol=1e-6, rtol=0, err_msg=k)
    assert np.isfinite(md_t["roc_auc"]).all()


def test_calibrated_cv_tail_matches_jax_host_isotonic_on_jax_trained_params():
    import jax.numpy as jnp
    from sklearn.isotonic import IsotonicRegression as SkIsotonic

    from pd_fusion_torch.nn.mlp import mlp_params_from_jax

    trained, Xs, yv, wv, Xc, yc = _jax_trained_stack(seed=1)
    K, S, nv = yv.shape
    n_cal = [10, 7, 10]  # a shorter calibration set, padded
    buf_j = np.asarray(JC._eval_probs_with_calib(trained, jnp.asarray(Xs), jnp.asarray(Xc)))
    buf_t = TC._probs_with_calib(mlp_params_from_jax(trained), torch.from_numpy(Xs),
                                 torch.from_numpy(Xc)).numpy()
    np.testing.assert_allclose(buf_t, buf_j, atol=1e-6, rtol=0)

    def tail(buf, isotonic_fits, metrics, to_array):
        raw = buf[:, : S * nv].reshape(K, S, nv)
        cal = np.empty_like(raw)
        for i, iso in enumerate(isotonic_fits(buf[:, S * nv:], yc, n_cal)):
            cal[i] = iso.transform(raw[i].ravel()).reshape(S, nv)
        return np.asarray(metrics(to_array(cal), to_array(yv), to_array(wv)))

    def sk_fits(cal_probs, cal_y, n):
        return [SkIsotonic(out_of_bounds="clip").fit(cal_probs[i, : n[i]], cal_y[i][: n[i]])
                for i in range(len(n))]

    # the JAX package's host arm, as PD_FUSION_HOST_ISOTONIC=1 runs it
    want = tail(buf_j, sk_fits, JC._metrics_from_probs_packed, jnp.asarray)
    got = tail(buf_t, TC._fit_isotonic_per_fold, TC._metrics_from_probs_packed, torch.from_numpy)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# whole single-split runs
# ---------------------------------------------------------------------------


def _files(d):
    return sorted(p.name for p in d.iterdir())


def test_quickstart_run_matches_the_jax_run(monkeypatch, tmp_path):
    """The port's quickstart, with its own draws, writes the JAX run's
    artifact names and result keys; fed the JAX package's own seed-42
    init and draws it gives the JAX run's results to 1e-3, whose
    full-observation ROC-AUC lies in the reference band 0.7121 +- 0.12.
    (The port's own seed-42 draws are another sample of the same
    distribution; see PERF.md.)"""
    want = JR.run_full_pipeline(QUICKSTART, synthetic=True,
                                overrides={"output_dir": str(tmp_path / "jax")})
    own = TR.run_full_pipeline(QUICKSTART, synthetic=True,
                               overrides={"output_dir": str(tmp_path / "own")})
    assert _files(tmp_path / "own") == _files(tmp_path / "jax")
    assert own.keys() == want.keys() and len(own) == 6
    assert all(own[s].keys() == want[s].keys() for s in want)
    assert np.isfinite(own["full_observation"]["roc_auc"])

    use_jax_draws(monkeypatch)
    got = TR.run_full_pipeline(QUICKSTART, synthetic=True,
                               overrides={"output_dir": str(tmp_path / "seam")})
    for scen in want:
        for metric, v in want[scen].items():
            assert got[scen][metric] == pytest.approx(v, abs=1e-3), (scen, metric)
    auc = got["full_observation"]["roc_auc"]
    assert abs(auc - REF_FULL_OBS_ROC_AUC) < 0.12, auc
    assert got["random_2_drop"]["roc_auc"] <= auc + 0.05
    prov = yaml.safe_load((tmp_path / "own" / "provenance.yaml").read_text())
    assert prov["env"]["device"] == "cpu" and prov["dataset"] == "ppmi"


@pytest.mark.parametrize("model_type", ["fusion_moddrop", "fusion_masked"])
def test_single_split_with_conformal_matches_the_jax_run(monkeypatch, tmp_path, model_type):
    """The conformal fit as the JAX package makes it: for fusion_masked it
    fails there (the val matrix lacks the mask columns) and is skipped with
    a warning, in both packages."""
    import pickle

    from pd_fusion_torch.models.conformal import MaskConformalWrapper

    overrides = {"model_type": model_type, "params": dict(SMALL), "conformal": True}
    want = JR.run_full_pipeline(QUICKSTART, synthetic=True,
                                overrides={**overrides, "output_dir": str(tmp_path / "jax")})
    use_jax_draws(monkeypatch)
    got = TR.run_full_pipeline(QUICKSTART, synthetic=True,
                               overrides={**overrides, "output_dir": str(tmp_path / "port")})
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert ("conformal_model.pkl" in _files(tmp_path / "port")) == (model_type == "fusion_moddrop")
    for scen in want:
        for metric, v in want[scen].items():
            assert got[scen][metric] == pytest.approx(v, abs=1e-3), (scen, metric)
    if model_type == "fusion_moddrop":
        cp = MaskConformalWrapper.load(tmp_path / "port" / "conformal_model.pkl")
        jcp = pickle.loads((tmp_path / "jax" / "conformal_model.pkl").read_bytes())
        assert cp.thresholds.keys() == jcp.thresholds.keys() and cp.thresholds
        for k, v in jcp.thresholds.items():
            assert cp.thresholds[k] == pytest.approx(v, abs=1e-4)
        assert cp.global_threshold == pytest.approx(jcp.global_threshold, abs=1e-4)


def test_evaluate_run_reproduces_the_runs_deterministic_scenarios(tmp_path):
    from pd_fusion_torch.paths import ROOT_DIR

    results = TR.run_full_pipeline(QUICKSTART, synthetic=True,
                                   overrides={"output_dir": str(tmp_path)})
    again = TR.evaluate_run(str(ROOT_DIR / "configs/eval_missingness.yaml"), str(tmp_path))
    assert (tmp_path / "results_eval.yaml").exists()
    for scen in ("full_observation", "no_dat", "no_mri", "clinical_only"):
        for metric, v in results[scen].items():
            assert again[scen][metric] == pytest.approx(v, abs=1e-6), (scen, metric)


def test_load_model_dispatches_the_ft_kind_and_refuses_unknown_kinds(tmp_path):
    from pd_fusion_torch.models.mil_attention_finetune import MilAttentionFineTuneModel
    from pd_fusion_torch.utils.io import save_pickle

    m = MilAttentionFineTuneModel({"backbone": "resnet18", "pretrained": False,
                                   "hidden_dim": 8, "attn_dim": 4})
    m.save(tmp_path / "ft.pt")
    loaded = load_model(tmp_path / "ft.pt")
    assert isinstance(loaded, MilAttentionFineTuneModel)
    assert torch.equal(loaded.backbone_params["conv1"]["w"], m.backbone_params["conv1"]["w"])
    assert torch.equal(loaded.head_params["instance"]["w"], m.head_params["instance"]["w"])
    save_pickle({"kind": "nonsense"}, tmp_path / "m.pt")
    with pytest.raises(ValueError):
        load_model(tmp_path / "m.pt")


def test_train_pipeline_trains_the_mil_finetune():
    """``mil_attention_ft`` through ``train_pipeline``: bags of prepped slice
    arrays (and one absent bag), the MIL prep info, finite probabilities."""
    from pd_fusion_torch.models.mil_attention_finetune import MilAttentionFineTuneModel

    rng = np.random.RandomState(0)
    bags = [rng.rand(4, 16, 16).astype(np.float32) for _ in range(8)] + [None]
    df = pd.DataFrame({"mri_mil": bags, TARGET_COL: [0, 1] * 4 + [1]})
    masks = {"mri": np.array([1] * 8 + [0])}
    config = {"model_type": "mil_attention_ft",
              "params": {"backbone": "resnet18", "pretrained": False, "input_size": 32,
                         "hidden_dim": 8, "attn_dim": 4, "batch_size": 4, "epochs": 1,
                         "freeze_backbone_epochs": 0}}
    model, prep = train_pipeline(config, df, df, masks, masks)
    assert isinstance(model, MilAttentionFineTuneModel) and prep == ("mil", "mri_mil")
    probs = predict_for_masks(model, df, masks, prep)
    assert probs.shape == (9,) and np.isfinite(probs).all() and probs[-1] == np.float32(0.5)


def test_model_loads_the_jax_packages_artifact(tmp_path):
    """A JAX run's model.pt loads into the port and predicts what the JAX
    model predicts (1e-6)."""
    from pd_fusion.models.serialization import load_model as jax_load_model

    JR.run_full_pipeline(QUICKSTART, synthetic=True, overrides={
        "output_dir": str(tmp_path), "model_type": "fusion_moddrop", "params": dict(SMALL)})
    rng = np.random.RandomState(0)
    X = rng.randn(40, 35).astype(np.float32)  # the quickstart's 10 + 5 + 20 features
    masks = {m: rng.randint(0, 2, 40) for m in MODALITIES}
    np.testing.assert_allclose(
        load_model(tmp_path / "model.pt").predict_proba(X, masks),
        np.asarray(jax_load_model(tmp_path / "model.pt").predict_proba(X, masks)),
        atol=1e-6, rtol=0)


def quickstart_auc_spread(n_draws, first_seed=1000):
    """The quickstart model's full-observation test ROC-AUC on the seed-42
    frame and split, over ``n_draws`` init-and-training chains of each
    package (seeds ``first_seed``, ``first_seed + 1``, ...: the torch
    generator chain for the port, the JAX key chain for the JAX package).
    -> {"port": aucs, "jax": aucs}."""
    import jax

    from pd_fusion.data.splits import get_subset_masks as j_subset
    from pd_fusion.evaluation.evaluate import evaluate_model as j_evaluate
    from pd_fusion.training.train import train_pipeline as j_train
    from pd_fusion.utils import seed as jseed
    from pd_fusion_torch.nn.trainer_checks import quickstart_auc_draws

    one = {"scenarios": [{"name": "full_observation", "drop_modalities": []}]}
    config, data_config, _ = JR._load_configs(QUICKSTART, {})
    aucs = []
    for s in range(first_seed, first_seed + n_draws):
        jseed.set_seed(42)
        _, df, masks = JR.load_dataset(config, data_config, True)
        tr, va, te = JR.stratified_split(df, seed=42)
        jseed._key = jax.random.PRNGKey(s)
        model, prep = j_train(dict(config), tr, va, j_subset(masks, tr.index),
                              j_subset(masks, va.index))
        res = j_evaluate(model, te, j_subset(masks, te.index), prep, one)
        aucs.append(res["full_observation"]["roc_auc"])
    return {"port": quickstart_auc_draws(n_draws, first_seed, QUICKSTART),
            "jax": np.asarray(aucs)}


def test_quickstart_auc_has_the_jax_packages_distribution():
    """The quickstart trains 5 full-batch steps, so its AUC is mostly set by
    the initial weights: over 24 chains each, the means of the two packages
    agree within 3 standard errors of their difference. (One chain, such as
    seed 42's, can land anywhere in about 0.6 +- 0.15.)"""
    spread = quickstart_auc_spread(24)
    p, j = spread["port"], spread["jax"]
    se = np.sqrt(p.var(ddof=1) / len(p) + j.var(ddof=1) / len(j))
    assert abs(p.mean() - j.mean()) < 3 * se, (p.mean(), j.mean(), se)
    assert 0.03 < p.std() < 0.15 and 0.03 < j.std() < 0.15  # a spread, not a constant


if __name__ == "__main__":
    # python tests/test_torch_port_tabular_slice.py [N]: the spread behind PERF.md
    import os
    import sys

    os.environ.setdefault("PD_FUSION_TORCH_DEVICE", "cpu")
    draws = quickstart_auc_spread(int(sys.argv[1]) if len(sys.argv) > 1 else 400)
    for name, aucs in draws.items():
        print(f"{name}: {len(aucs)} draws, mean {aucs.mean():.4f}, std {aucs.std(ddof=1):.4f}, "
              f"in 0.7121 +- 0.12: {np.mean(np.abs(aucs - REF_FULL_OBS_ROC_AUC) < 0.12):.3f}")
