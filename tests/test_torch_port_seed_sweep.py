"""The port's fused multi-seed sweep (``pd_fusion_torch/parallel/seed_sweep.py``)
and the CV engine's explicit-folds seams, against the JAX package's sweep
and against the port's own standalone runs (CPU), on the JAX tests' own
frames (``tests/test_seed_sweep.py``).

What is held, and how close:
- the artifact layout of ``test_seed_sweep.py:13-55``: one run directory
  per seed with the provenance, the resolved config, each fold's results
  and predictions and the aggregate, which the port's aggregator reads;
- fused against a standalone ``run_parallel_cv`` under each seed: to 1e-6
  for the MLP family (equal folds: the same generators, the same padded
  width) and 5e-3 for the device GBDT (the JAX test's tolerance; exact gain
  ties may fall either way between two stack widths, the JAX test's note
  at ``test_seed_sweep.py:140-155``);
- the port's fused sweep against the JAX fused sweep, both fed the JAX
  package's draws (``test_torch_port_jax_draws.use_jax_draws``), for
  ``fusion_moddrop`` and ``moe``: every fold's metrics within 1e-3, the
  tolerance of ``test_torch_port_tabular_cv.py`` (rounding drift over the
  training steps; one swapped pair moves a fold's ROC-AUC by about 1e-3),
  and the full-observation predictions within 1e-4;
- the seams left ``None`` give today's draws: the engine's explicit-seam
  call with the pairs and masks it would draw and slice itself returns the
  same numbers, bit for bit, for the MLP, MoE and GBDT branches;
- nested calibration with explicit fold masks raises, as in JAX.
"""
import numpy as np
import pandas as pd
import pytest
import yaml

from pd_fusion.utils import seed as jseed
from pd_fusion_torch.data.splits import get_kfold_splits, get_subset_masks
from pd_fusion_torch.experiments.run_experiment import load_dataset
from pd_fusion_torch.parallel import cv_engine, seed_sweep
from pd_fusion_torch.parallel.cv_engine import run_parallel_cv
from pd_fusion_torch.utils.io import load_yaml
from pd_fusion_torch.utils.seed import fresh_generator, set_seed
from test_torch_port_jax_draws import JaxKey, one_cpu_thread, use_jax_draws

FULL_OBS = {"scenarios": [{"name": "full_observation", "drop_modalities": []}]}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("PD_FUSION_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("PD_FUSION_GBDT_BACKEND", raising=False)
    with one_cpu_thread():
        yield


def _config(model_type, params, **extra):
    config = load_yaml("configs/quickstart.yaml")
    config.update({"model_type": model_type, "params": params, **extra})
    return config


def _read_preds(run_dir, i):
    return pd.read_csv(run_dir / f"preds_fold_{i}_full_observation.csv")


def test_fused_multi_seed_sweep_layout(tmp_path):
    """``test_seed_sweep.py::test_fused_multi_seed_sweep`` on the port."""
    from pd_fusion_torch.analysis.aggregate_results import aggregate

    config = _config("fusion_moddrop", {"hidden_dims": [16], "dropout": 0.1, "lr": 0.01,
                                        "batch_size": 32, "epochs": 20, "moddrop_rate": 0.3})
    seeds = [42, 43, 44]
    out, sweep_dir = seed_sweep.run_multi_seed_cv(
        config, load_yaml("configs/data_ppmi.yaml"), load_yaml("configs/eval_missingness.yaml"),
        seeds=seeds, k=3, synthetic=True, sweep_dir=tmp_path / "sweep")
    assert sweep_dir == tmp_path / "sweep" and set(out) == set(seeds)
    for seed in seeds:
        run_dir = sweep_dir / f"fusion_moddrop_s{seed}"
        for name in ("results_aggregated.yaml", "resolved_config.yaml", "provenance.yaml",
                     "eval_config.yaml"):
            assert (run_dir / name).exists(), name
        for i in (1, 2, 3):
            assert (run_dir / f"results_fold_{i}.yaml").exists()
            assert list(_read_preds(run_dir, i).columns) == ["y_true", "y_prob", "fold"]
        assert yaml.safe_load((run_dir / "provenance.yaml").read_text())["seed"] == seed
        assert len(out[seed]) == 6
        auc = out[seed]["full_observation"]["roc_auc"]["mean"]
        assert 0.55 < auc <= 1.0, (seed, auc)
    p42, p43 = (_read_preds(sweep_dir / f"fusion_moddrop_s{s}", 1) for s in (42, 43))
    assert not p42["y_prob"].equals(p43["y_prob"])

    df = aggregate(sweep_dir, tmp_path / "summary.csv")
    assert len(df[df["Scenario"] == "full_observation"]) == 3
    assert set(df["Seed"]) == set(seeds)


CASES = {
    "fusion_moddrop": (_config("fusion_moddrop", {
        "hidden_dims": [8], "dropout": 0.2, "lr": 0.01, "batch_size": 32, "epochs": 5,
        "moddrop_rate": 0.3}), 1e-6),
    "unimodal_gbdt-device": (_config("unimodal_gbdt", {
        "backend": "device", "n_estimators": 10, "max_depth": 3}, modality="clinical"), 5e-3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_sweep_reproduces_standalone_seed_runs(tmp_path, case):
    """Each seed's fused predictions against ``run_parallel_cv`` under that
    seed alone (N=500, k=2: equal folds)."""
    config, atol = CASES[case]
    data_config = load_yaml("configs/data_ppmi.yaml")
    seeds = [41, 42]
    seed_sweep.run_multi_seed_cv(config, data_config, FULL_OBS, seeds=seeds, k=2,
                                 synthetic=True, sweep_dir=tmp_path / "sweep")
    for seed in seeds:
        cfg_s = dict(config, seed=seed)
        set_seed(seed)
        _, df, masks = load_dataset(cfg_s, data_config, True)
        folds = list(get_kfold_splits(df, n_splits=2, seed=seed))
        _, fold_preds = run_parallel_cv(cfg_s, df, masks, folds, FULL_OBS)
        for i in (1, 2):
            fused = _read_preds(tmp_path / "sweep" / f"{config['model_type']}_s{seed}", i)
            assert (fused["y_true"].values == fold_preds[i - 1][0]).all()
            np.testing.assert_allclose(fused["y_prob"].values, fold_preds[i - 1][1], rtol=0,
                                       atol=atol, err_msg=f"seed {seed} fold {i}")


# 3 epochs: later, rounding drift can fork a run. At seed 41, fold 2 of this
# frame, a standalone port run fed the JAX draws is within 5e-6 of the JAX
# run through epoch 3 and 4.7e-4 apart after epoch 4 (8.8e-3 after 5): a
# weight whose gradient is rounding noise takes Adam's step of about lr in
# one package and not in the other. The fused sweep inherits it unchanged.
SEAM_PARAMS = {
    "fusion_moddrop": {"hidden_dims": [12, 6], "dropout": 0.2, "lr": 0.02, "batch_size": 32,
                       "epochs": 3, "moddrop_rate": 0.3},
    "moe": {"expert_hidden_dims": [8], "router_hidden_dims": [4], "lr": 0.01, "epochs": 3},
}


def _capture_probs(monkeypatch, module, store, key):
    """Record the [folds, scenarios, N] probabilities an engine unpacks."""
    unpack = module.unpack_metrics_and_probs

    def recording(*args, **kwargs):
        md, probs = unpack(*args, **kwargs)
        store[key] = np.array(probs)
        return md, probs

    monkeypatch.setattr(module, "unpack_metrics_and_probs", recording)


def _tie_counts(p):
    return sorted(np.unique(p, return_counts=True)[1])


@pytest.mark.parametrize("model_type", list(SEAM_PARAMS))
def test_fused_sweep_matches_the_jax_fused_sweep(tmp_path, monkeypatch, model_type):
    """Both packages' fused sweeps over seeds 41, 42 (k=3, 6 scenarios), the
    port fed the JAX package's init and draws: every scenario's
    probabilities within 1e-4, every fold's metrics within 1e-3 and every
    seed's run directory holding the same files. Where a scenario's
    probabilities tie differently (one subject inside a tie group in one
    package and a rounding step off it in the other: with ``random_2_drop``
    the subjects left with no modality share one MoE output), its ROC-AUC
    and PR-AUC may move by a share of the tie group's pairs and are not
    held; the probabilities still are."""
    from pd_fusion.ops import metrics as JM
    from pd_fusion.parallel import seed_sweep as JS
    from pd_fusion_torch.ops import metrics as TM

    config = _config(model_type, SEAM_PARAMS[model_type], cv_mesh="off")
    data_config = load_yaml("configs/data_ppmi.yaml")
    eval_config = load_yaml("configs/eval_missingness.yaml")
    seeds, k = [41, 42], 3
    probs = {}
    _capture_probs(monkeypatch, JM, probs, "jax")
    _capture_probs(monkeypatch, TM, probs, "port")
    JS.run_multi_seed_cv(dict(config), data_config, eval_config, seeds=seeds, k=k,
                         synthetic=True, sweep_dir=tmp_path / "jax")
    use_jax_draws(monkeypatch)

    def both_set_seed(seed=42):
        set_seed(seed)
        jseed.set_seed(seed)

    monkeypatch.setattr(seed_sweep, "set_seed", both_set_seed)
    monkeypatch.setattr(seed_sweep, "fresh_generator",
                        lambda device=None: JaxKey(jseed.fresh_key()))
    seed_sweep.run_multi_seed_cv(dict(config), data_config, eval_config, seeds=seeds, k=k,
                                 synthetic=True, sweep_dir=tmp_path / "port")
    np.testing.assert_allclose(probs["port"], probs["jax"], rtol=0, atol=1e-4)
    names = [s["name"] for s in eval_config["scenarios"]]
    for si_seed, seed in enumerate(seeds):
        jdir, tdir = (tmp_path / p / f"{model_type}_s{seed}" for p in ("jax", "port"))
        assert sorted(p.name for p in tdir.iterdir()) == sorted(p.name for p in jdir.iterdir())
        for i in range(1, k + 1):
            fi = si_seed * k + i - 1
            jf, tf = (yaml.safe_load((d / f"results_fold_{i}.yaml").read_text())
                      for d in (jdir, tdir))
            assert tf.keys() == jf.keys()
            for scen in jf:
                if scen == "fold":
                    continue
                si = names.index(scen)
                same_ties = (_tie_counts(probs["port"][fi, si])
                             == _tie_counts(probs["jax"][fi, si]))
                for metric, v in jf[scen].items():
                    if same_ties or metric not in ("roc_auc", "pr_auc"):
                        assert tf[scen][metric] == pytest.approx(v, abs=1e-3), (
                            seed, i, scen, metric)
            jp, tp = (_read_preds(d, i) for d in (jdir, tdir))
            assert (tp["y_true"] == jp["y_true"]).all()
            np.testing.assert_allclose(tp["y_prob"], jp["y_prob"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("config", [
    _config("fusion_moddrop", SEAM_PARAMS["fusion_moddrop"]),
    _config("moe", SEAM_PARAMS["moe"]),
    _config("unimodal_gbdt", {"backend": "device", "n_estimators": 5, "max_depth": 3},
            modality="clinical"),
], ids=["fusion_moddrop", "moe", "unimodal_gbdt-device"])
def test_seams_left_none_give_todays_draws(config):
    """``run_parallel_cv`` with both seams ``None`` against the same call
    handed the generators it draws (interleaved pairs from the chain; the
    MoE branch draws one init generator per fold and reads only a pair's
    first) and the masks it slices: the same numbers, bit for bit."""
    data_config = load_yaml("configs/data_ppmi.yaml")
    eval_config = load_yaml("configs/eval_missingness.yaml")
    runs = []
    for explicit in (False, True):
        set_seed(7)
        _, df, masks = load_dataset(config, data_config, True)
        folds = list(get_kfold_splits(df, n_splits=3, seed=7))
        kw = {}
        if explicit:
            kw = {"fold_masks": [(get_subset_masks(masks, tr.index),
                                  get_subset_masks(masks, va.index)) for tr, va in folds],
                  "fold_generators": [
                      (fresh_generator(),
                       None if config["model_type"] == "moe" else fresh_generator("cpu"))
                      for _ in folds]}
        runs.append(run_parallel_cv(config, None if explicit else df,
                                    None if explicit else masks, folds, eval_config, **kw))
    (m0, p0), (m1, p1) = runs
    assert m0 == m1
    for (y0, q0), (y1, q1) in zip(p0, p1):
        np.testing.assert_array_equal(q0, q1)


def test_nested_calibration_with_explicit_fold_masks_raises():
    config = _config("fusion_late", SEAM_PARAMS["fusion_moddrop"], calibrate=True,
                     nested_calibration=True)
    set_seed(3)
    _, df, masks = load_dataset(config, load_yaml("configs/data_ppmi.yaml"), True)
    folds = list(get_kfold_splits(df, n_splits=2, seed=3))
    fold_masks = [(get_subset_masks(masks, tr.index), get_subset_masks(masks, va.index))
                  for tr, va in folds]
    with pytest.raises(ValueError, match="nested calibration"):
        cv_engine.run_parallel_cv(config, None, None, folds, FULL_OBS, fold_masks=fold_masks)


def _bag_frame(config, data_config, synthetic):
    """A ds001907-like frame of MIL bags: 20 subjects x 2 sessions, a
    missing bag every 9th row, drawn from the seed's numpy state."""
    rng = np.random.RandomState(config["seed"])
    n = 40
    y = np.repeat(rng.randint(0, 2, n // 2), 2)
    bags = []
    for i in range(n):
        bag = rng.randn(rng.randint(3, 9), 6).astype(np.float32)
        bag[:2] += 1.5 * y[i]
        bags.append(None if i % 9 == 4 else bag)
    df = pd.DataFrame({"subject_id": np.repeat([f"s{i}" for i in range(n // 2)], 2),
                       "diagnosis": y, "mri_mil": bags})
    zeros = np.zeros(n, np.float32)
    mri = np.array([b is not None for b in bags], np.float32)
    return "openneuro_ds001907", df, {"clinical": zeros, "datspect": zeros.copy(), "mri": mri}


MIL_CONFIG = {"model_type": "mil_attention", "mil_column": "mri_mil", "group_col": "subject_id",
              "params": {"hidden_dim": 8, "attn_dim": 4, "dropout": 0.2, "gated": True,
                         "class_weight": "balanced", "lr": 0.01, "batch_size": 4, "epochs": 3,
                         "early_stopping_patience": 2, "max_grad_norm": 1.0}}


@pytest.mark.parametrize("k", [2, 3])
def test_fused_mil_sweep_against_standalone_runs(tmp_path, k):
    """The MIL branch through both seams (the JAX engine refuses explicit
    fold masks for MIL; the port takes them). Every fold of the sweep pads
    its kept training bags to the widest fold of all seeds, and all take
    the smallest fold's batch size, so a seed whose own widths differ draws
    its shuffles over another width than its standalone run. Held: the
    layout, finite predictions for every row, and predictions within 1e-6
    of the standalone run for each seed whose widths are the sweep's (k=2:
    18 kept training bags in every fold of both seeds; k=3: seed 6's folds
    hold 23, 26, 23 and seed 5's 24, 24, 24, so only seed 6 is held)."""
    from pd_fusion_torch.data.splits import get_group_kfold_splits

    config = {**MIL_CONFIG, "params": dict(MIL_CONFIG["params"])}
    seeds = [5, 6]
    out, sweep_dir = seed_sweep.run_multi_seed_cv(config, {}, FULL_OBS, seeds=seeds, k=k,
                                                  synthetic=False, sweep_dir=tmp_path / "sweep",
                                                  dataset_loader=_bag_frame)
    assert set(out) == set(seeds)
    runs = {}
    for seed in seeds:
        cfg_s = dict(config, seed=seed)
        set_seed(seed)
        _, df, masks = _bag_frame(cfg_s, {}, False)
        folds = list(get_group_kfold_splits(df, n_splits=k, seed=seed, group_col="subject_id"))
        kept = [int(tr["mri_mil"].notna().sum()) for tr, _ in folds]
        runs[seed] = (kept, run_parallel_cv(cfg_s, df, masks, folds, FULL_OBS)[1])
    widths = [w for kept, _ in runs.values() for w in kept]
    for seed, (kept, fold_preds) in runs.items():
        same = (max(kept), min(kept)) == (max(widths), min(widths))
        assert same == (k == 2 or seed == 6)
        for i in range(1, k + 1):
            fused = _read_preds(sweep_dir / f"mil_attention_s{seed}", i)
            assert np.isfinite(fused["y_prob"]).all() and len(fused) == len(fold_preds[i - 1][0])
            assert (fused["y_true"].values == fold_preds[i - 1][0]).all()
            if same:
                np.testing.assert_allclose(fused["y_prob"].values, fold_preds[i - 1][1], rtol=0,
                                           atol=1e-6, err_msg=f"seed {seed} fold {i}")
