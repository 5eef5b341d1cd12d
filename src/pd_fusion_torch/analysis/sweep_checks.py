"""Checks of the sweep tier's and the stress test's device programs, shared
by ``chip_smoke.py`` and the ``cuda``-marked tests
(``tests/test_torch_port_cuda.py``).

- the bootstrap (``analysis/bootstrap_ci.py``): every resample's six
  metrics as one batched program on ``device`` and on the CPU, from the
  same numpy resample indices. The ROC-AUC sums are of 0/1 and halves,
  exact in float32 at these sizes; the Brier score, PR-AUC and the ECE's
  bin sums are float32 sums of up to N terms in another order on the card
  than on the CPU (a fixed order on each: two runs on one card are equal
  bit for bit, ``utils/determinism_checks.py``), so the metrics agree to
  ``BOOT_ATOL``;
- the stress test's MLP (``scripts/ppmi_stress_test.py::fit_moddrop_mlp``):
  one fold's whole training run on ``device`` and on the CPU from one init
  and the same draws, held as the tabular trainer is
  (``nn/trainer_checks.py``: ``FULL_ATOL`` on the weights and the held-out
  probabilities);
- the fused sweep against standalone runs (``standalone_gaps``): each
  seed's fused predictions against ``run_parallel_cv`` under that seed
  alone, on one device. Equal folds give the same generators and widths,
  so the gap is rounding: cuBLAS may pick another algorithm for S x K
  batch entries than for K. The device GBDT can fork on an exact gain tie
  (the JAX test's 5e-3); ragged folds (group K-fold) pad to other widths.
"""
import numpy as np
import torch

from pd_fusion_torch.nn.trainer_checks import FULL_ATOL

BOOT_ATOL = 1e-5
# the fused tabular sweep's pooled predictions of one model: 3 seeds x the
# quickstart's N=500; the CLI's default of 1,000 resamples
BOOT_SHAPE = (1000, 1500)
# one fold of the stress test at the synthetic study data's size (1,500
# subjects, 5 folds, 184 features) with its defaults: 30 epochs, batch 128
STRESS_SHAPE = (1200, 184)
STRESS_HP = dict(epochs=30, batch_size=128, moddrop_prob=0.3, lr=1e-3)


def bootstrap_inputs(n=BOOT_SHAPE[0], N=BOOT_SHAPE[1], seed=0):
    """Labels and probabilities of N pooled rows (some tied) and the [n, N]
    numpy resample indices -> (y_r, p_r) float32 CPU tensors."""
    from pd_fusion_torch.analysis.bootstrap_ci import resample_indices

    rng = np.random.RandomState(seed)
    y = (rng.rand(N) < 0.6).astype(np.float32)
    p = np.clip(rng.rand(N) * 0.6 + 0.35 * y, 0.0, 1.0).astype(np.float32)
    p[: N // 5] = np.round(p[: N // 5], 2)
    idx = resample_indices(N, n, seed)
    return torch.from_numpy(y[idx]), torch.from_numpy(p[idx])


def check_bootstrap(device="cuda", n=BOOT_SHAPE[0], N=BOOT_SHAPE[1], seed=0) -> float:
    """The batched resample metrics on ``device`` against the CPU -> the
    largest difference over every metric and resample."""
    from pd_fusion_torch.ops.metrics import binary_metrics

    y_r, p_r = bootstrap_inputs(n, N, seed)
    got = binary_metrics(y_r.to(device), p_r.to(device))
    want = binary_metrics(y_r, p_r)
    err = max(float(torch.max(torch.abs(got[k].cpu() - want[k]))) for k in want)
    if not err <= BOOT_ATOL:
        raise AssertionError(f"bootstrap metrics on {device} vs CPU: {err:.3e} > {BOOT_ATOL}")
    return err


def stress_fold_inputs(X, y, group_idx, seed, epochs=STRESS_HP["epochs"],
                       batch_size=STRESS_HP["batch_size"],
                       moddrop_prob=STRESS_HP["moddrop_prob"]):
    """CPU tensors of one stress-test fold's training run as the script
    makes it (``train_moddrop_mlp`` with ``seed``): features, labels, the
    group one-hots, the initial weights and every draw."""
    from pd_fusion_torch.nn.mlp import mlp_init
    from pd_fusion_torch.scripts import ppmi_stress_test as st

    n, F = X.shape
    clin, img = (torch.from_numpy(a) for a in st._make_group_onehots(F, group_idx))
    init, train = st.mlp_generators(seed, "cpu")
    params = mlp_init(init, [F + 2, *st.HIDDEN, 1])
    bs = min(batch_size, n)
    draws = st.draw_stress(train, epochs, n, bs, moddrop_prob, st.DROPOUT, "cpu")
    return {"X": torch.as_tensor(X, dtype=torch.float32), "y": torch.as_tensor(
        y, dtype=torch.float32), "clin": clin, "img": img, "params": params, "draws": draws,
        "batch_size": bs, "group_idx": group_idx}


def stress_inputs(n=STRESS_SHAPE[0], F=STRESS_SHAPE[1], seed=0, **hp):
    """``stress_fold_inputs`` on seeded synthetic features (the first 40%
    clinical, the rest imaging)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    y = (X[:, 0] - X[:, -1] + 0.5 * rng.randn(n) > 0).astype(np.float32)
    n_clin = int(0.4 * F)
    group_idx = {"clinical": list(range(n_clin)), "imaging": list(range(n_clin, F))}
    return stress_fold_inputs(X, y, group_idx, seed, **hp)


def _to(x, device):
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, device) for v in x)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    return x.to(device) if isinstance(x, torch.Tensor) else x


def check_stress_training(device="cuda", inputs=None, lr=STRESS_HP["lr"]):
    """One fold's training run on ``device`` and on the CPU from the same
    init and draws -> (weights' largest difference, held-out
    probabilities' largest difference)."""
    from pd_fusion_torch.nn.mlp import mlp_apply
    from pd_fusion_torch.scripts import ppmi_stress_test as st

    inp = inputs or stress_inputs()
    runs = []
    for dev in (device, "cpu"):
        a = _to(inp, dev)
        trained = st.fit_moddrop_mlp(a["params"], a["X"], a["y"], a["clin"], a["img"],
                                     a["draws"], lr, a["batch_size"])
        X_held = a["X"][:256]
        X_eval = torch.cat([X_held, torch.ones((len(X_held), 2), device=dev)], dim=1)
        with torch.no_grad():
            prob = torch.sigmoid(mlp_apply(trained, X_eval))
        runs.append(([v.cpu() for layer in trained for v in layer.values()], prob.cpu()))
    (w_dev, p_dev), (w_cpu, p_cpu) = runs
    w_err = max(float(torch.max(torch.abs(a - b))) for a, b in zip(w_dev, w_cpu))
    p_err = float(torch.max(torch.abs(p_dev - p_cpu)))
    if not (w_err <= FULL_ATOL[0] and p_err <= FULL_ATOL[1]):
        raise AssertionError(f"stress MLP on {device} vs CPU: weights {w_err:.3e}, "
                             f"probabilities {p_err:.3e} (tolerance {FULL_ATOL})")
    return w_err, p_err


def standalone_gaps(config, data_config, eval_config, seeds, k, run_root, synthetic=True,
                    dataset_loader=None):
    """Each seed's fused predictions (``run_root/<model>_s<seed>/``) against
    a standalone ``run_parallel_cv`` under that seed on the port's device
    -> {seed: largest absolute difference over its folds}; the labels must
    be equal."""
    import copy

    import pandas as pd

    from pd_fusion_torch.data.splits import get_group_kfold_splits, get_kfold_splits
    from pd_fusion_torch.experiments.run_experiment import load_dataset
    from pd_fusion_torch.parallel.cv_engine import run_parallel_cv
    from pd_fusion_torch.training.train import _resolve_params
    from pd_fusion_torch.utils.seed import set_seed

    loader = dataset_loader or load_dataset
    group_col = config.get("group_col") or config.get("cv_group_col")
    gaps = {}
    for seed in seeds:
        cfg_s = copy.deepcopy(config)
        cfg_s["seed"] = seed
        set_seed(seed)
        _, df, masks = loader(cfg_s, data_config, synthetic)
        if group_col:
            folds = list(get_group_kfold_splits(df, n_splits=k, seed=seed, group_col=group_col))
        else:
            folds = list(get_kfold_splits(df, n_splits=k, seed=seed))
        _resolve_params(cfg_s, cfg_s["model_type"])
        _, fold_preds = run_parallel_cv(cfg_s, df, masks, folds, eval_config)
        gap = 0.0
        for i, (y_true, y_prob) in enumerate(fold_preds, start=1):
            fused = pd.read_csv(run_root / f"{config['model_type']}_s{seed}"
                                / f"preds_fold_{i}_full_observation.csv")
            if not (fused["y_true"].to_numpy() == y_true).all():
                raise AssertionError(f"seed {seed} fold {i}: the fused labels differ")
            gap = max(gap, float(np.abs(fused["y_prob"].to_numpy() - y_prob).max()))
        gaps[seed] = gap
    return gaps
