"""Two-modality stress test (port of ``scripts/ppmi_stress_test.py``, same
flags and artifacts):

    python -m pd_fusion_torch.scripts.ppmi_stress_test
        [--input-csv data/processed/ppmi/ppmi_subject_baseline.csv] [--output-dir D]
        [--folds 5] [--seed 42] [--epochs 30] [--batch-size 128] [--moddrop-prob 0.3]
        [--num-threads T]

Non-motor clinical against imaging features under ``full``,
``missing_clinical`` and ``missing_imaging`` (the block zeroed at test
time), K-fold stratified CV: a gradient-boosted tree against a ModDrop MLP
that zeroes the clinical or the imaging block per sample while training
and sees the keep vector as two extra inputs. Writes
``stress_test_per_fold.csv``, ``stress_test_summary.csv`` and, where
matplotlib is installed, ``stress_test_roc_auc.{png,pdf}``.

No scikit-learn: the folds are ``data/splits.py::_stratified_kfold``
(``StratifiedKFold(shuffle=True, random_state=seed)``), the median impute
and the scaler ``analysis/column_transformer.py::NumericBlock`` without
indicators; the tree arm is ``analysis/tabular.py::boosted_tree`` (the
folds' device GBDTs as one fold-batched fit). The MLP is this script's own
trainer: layers [F+2, 128, 64, 1], dropout 0.2, Adam at lr 1e-3, padded
rows at weight 0. Its permutations, per-sample keeps and dropout keeps
are drawn up front (``draw_stress``) from the generators of
``mlp_generators(seed)``, so a caller can hand it other draws.
``LAST_TIMINGS`` holds the last run's wall seconds per stage.
"""
import argparse
import datetime
import logging
import os
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import pandas as pd
import torch

from pd_fusion_torch.analysis.tabular import coerce_numeric, grep_columns, suite_logger
from pd_fusion_torch.nn.mlp import bce_with_logits, mlp_apply, mlp_init
from pd_fusion_torch.utils.device import get_device

ID_COLS = {"subject_id", "visit_id", "visit_month", "date"}
GLOBAL_EXCLUDE = [
    r"^.*date.*$", r"^.*time.*$", r"^.*event.*$", r"^.*protocol.*$", r"^.*dose.*$",
    r"^.*site.*$", r"^.*center.*$", r"^.*scanner.*$", r"^.*acq.*$", r"^.*acquisition.*$",
    r"^.*series.*$", r"^.*version.*$", r"^.*reason.*$", r"^.*not_analyzed.*$",
    r"^.*notanalyzed.*$",
]
NONMOTOR_PATTERNS = [
    r"moca", r"cognition", r"sleep", r"epworth", r"rbd", r"rem", r"depress", r"gds",
    r"bdi", r"anxiety", r"stai", r"mood", r"upsit", r"smell", r"autonomic",
]
DATSBR_PATTERNS = [r"datscan", r"sbr", r"putamen", r"caudate", r"striat", r"asym"]
MRI_PATTERNS = [
    r"mri_derived__", r"thickness", r"cortical", r"volume", r"area", r"aseg", r"hippo",
    r"entorhinal", r"amygdala", r"caudate", r"putamen", r"pallid", r"thalam", r"accumbens",
]
HIDDEN = (128, 64)
DROPOUT = 0.2
LAST_TIMINGS: Dict[str, float] = {}


def setup_logging(out_dir: Path) -> logging.Logger:
    return suite_logger("ppmi_stress", out_dir, "ppmi_stress_test.log")


def filter_cols(cols, patterns):
    return grep_columns(cols, allow=patterns)


def exclude_cols(cols, patterns):
    return grep_columns(cols, deny=patterns)


select_numeric = coerce_numeric


def build_groups(df: pd.DataFrame) -> Dict[str, List[str]]:
    cols = exclude_cols([c for c in df.columns if c not in ID_COLS and c != "label"],
                        GLOBAL_EXCLUDE)
    num_df = select_numeric(df, cols)
    all_cols = [c for c in num_df.columns if num_df[c].notna().any()]
    nonmotor = filter_cols(all_cols, NONMOTOR_PATTERNS)
    datsbr = filter_cols(all_cols, DATSBR_PATTERNS)
    mri = filter_cols(all_cols, MRI_PATTERNS)
    imaging = sorted(set(datsbr + mri))
    return {
        "clinical": nonmotor,
        "imaging": imaging,
        "full": sorted(set(nonmotor + imaging)),
        "datsbr": datsbr,
        "mri": mri,
    }


# ---------------------------------------------------------------------------
# per-sample ModDrop MLP
# ---------------------------------------------------------------------------


def _make_group_onehots(n_features, group_idx):
    clin = np.zeros(n_features, np.float32)
    clin[group_idx["clinical"]] = 1.0
    img = np.zeros(n_features, np.float32)
    img[group_idx["imaging"]] = 1.0
    return clin, img


def mlp_generators(seed: int, device):
    """(init, train) generators of one fold's MLP, seeded ``seed`` and
    ``seed + 1`` as the JAX script seeds its two keys."""
    return (torch.Generator().manual_seed(int(seed)),
            torch.Generator(device=device).manual_seed(int(seed) + 1))


def draw_stress(generator, epochs: int, n: int, batch_size: int, moddrop_prob: float,
                dropout: float, device):
    """Every draw of a training run, in order: the permutations [E, n] (the
    stable argsort of float64 uniforms), the per-sample keeps [E, nb, bs, 2]
    (1.0 where a uniform exceeds ``moddrop_prob``) and the dropout keeps,
    one [E, nb, bs, h] bool tensor per hidden layer."""
    nb = -(-n // batch_size)
    perms = torch.argsort(
        torch.rand((epochs, n), generator=generator, device=device, dtype=torch.float64),
        dim=-1, stable=True)
    keeps = (torch.rand((epochs, nb, batch_size, 2), generator=generator, device=device)
             > moddrop_prob).to(torch.float32)
    dropout_keep = [torch.rand((epochs, nb, batch_size, h), generator=generator, device=device)
                    < 1.0 - dropout for h in HIDDEN]
    return perms, keeps, dropout_keep


def moddrop_loss(p, Xb, yb, wb, keep, dk, clin, img):
    """One batch's loss: the per-sample keep [bs, 2] zeroes the clinical and
    imaging blocks and is concatenated onto the input."""
    feat_keep = 1.0 - torch.outer(1.0 - keep[:, 0], clin) - torch.outer(1.0 - keep[:, 1], img)
    Xin = torch.cat([Xb * feat_keep, keep], dim=1)
    logits = mlp_apply(p, Xin, dropout_rate=DROPOUT, dropout_keep=dk)
    return bce_with_logits(logits, yb, wb)


def fit_moddrop_mlp(params, X, y, clin, img, draws, lr: float, batch_size: int):
    """Adam over every epoch's padded minibatches (the index list padded
    with row 0, the padding rows at weight 0) -> trained params."""
    from pd_fusion_torch.nn.trainer import _step, make_optimizer

    perms, keeps, dropout_keep = draws
    n, dev = X.shape[0], X.device
    n_batches = -(-n // batch_size)
    pad = n_batches * batch_size - n
    p = [{k: v.detach().clone().requires_grad_(True) for k, v in layer.items()}
         for layer in params]
    leaves = [layer[k] for layer in p for k in ("w", "b")]
    opt = make_optimizer(leaves, lr)
    wpad = torch.cat([torch.ones(n, device=dev), torch.zeros(pad, device=dev)]
                     ).reshape(n_batches, batch_size)
    pad_idx = torch.zeros(pad, dtype=torch.long, device=dev)
    for e in range(perms.shape[0]):
        idx = torch.cat([perms[e].to(dev, torch.long), pad_idx]).reshape(n_batches, batch_size)
        for b in range(n_batches):
            dk = [d[e, b] for d in dropout_keep]
            _step(opt, leaves, moddrop_loss(p, X[idx[b]], y[idx[b]], wpad[b], keeps[e, b], dk,
                                            clin, img))
    return [{k: v.detach() for k, v in layer.items()} for layer in p]


def train_moddrop_mlp(X_train, y_train, group_idx, moddrop_prob, epochs, batch_size, lr, seed,
                      device=None):
    """Train one fold's MLP (the JAX script's ``train_moddrop_mlp_jax``) ->
    ``predict(X, drop)``; the trained params are ``predict.params``."""
    dev = get_device(device)
    n, F = X_train.shape
    clin, img = (torch.as_tensor(a, device=dev) for a in _make_group_onehots(F, group_idx))
    init_gen, train_gen = mlp_generators(seed, dev)
    params = mlp_init(init_gen, [F + 2, *HIDDEN, 1], device=dev)
    batch_size = min(batch_size, n)
    draws = draw_stress(train_gen, epochs, n, batch_size, moddrop_prob, DROPOUT, dev)
    trained = fit_moddrop_mlp(params, torch.as_tensor(X_train, dtype=torch.float32, device=dev),
                              torch.as_tensor(y_train, dtype=torch.float32, device=dev),
                              clin, img, draws, lr, batch_size)

    def predict(X, drop):
        keep_vec = np.array(
            [0.0 if drop.get("clinical") else 1.0, 0.0 if drop.get("imaging") else 1.0],
            np.float32,
        )
        Xm = mask_features(np.asarray(X, np.float32), group_idx, drop)
        Xin = np.concatenate([Xm, np.tile(keep_vec, (len(Xm), 1))], axis=1)
        with torch.no_grad():
            return torch.sigmoid(mlp_apply(trained, torch.as_tensor(Xin, device=dev))).cpu().numpy()

    predict.params = trained
    return predict


def mask_features(X, group_idx, drop):
    X_masked = X.copy()
    for name, idxs in group_idx.items():
        if drop.get(name, False) and len(idxs):
            X_masked[:, idxs] = 0.0
    return X_masked


def scaled_features(df: pd.DataFrame, feature_cols) -> np.ndarray:
    """``StandardScaler().fit_transform(SimpleImputer(strategy="median")
    .fit_transform(X))`` on the whole frame, as the JAX script does."""
    from pd_fusion_torch.analysis.column_transformer import NumericBlock

    return NumericBlock(scale=True, add_indicator=False).fit_transform(
        select_numeric(df, feature_cols))


def run_stress_test(df, out_dir: Path, folds=5, seed=42, epochs=30, batch_size=128,
                    moddrop_prob=0.3, num_threads=2, logger=None):
    from pd_fusion_torch.analysis.tabular import boosted_tree, fit_boosted_trees
    from pd_fusion_torch.data.splits import _stratified_kfold
    from pd_fusion_torch.utils.metrics import compute_metrics

    out_dir = Path(out_dir)
    logger = logger or logging.getLogger("ppmi_stress")
    clock = {k: 0.0 for k in ("prep_s", "lgbm_s", "mlp_s", "metrics_s")}
    t_run = time.perf_counter()
    df = df.dropna(subset=["label"]).copy()
    groups = build_groups(df)
    if not groups["clinical"] or not groups["imaging"]:
        raise ValueError("Need both clinical (non-motor) and imaging features for stress test")

    t0 = time.perf_counter()
    feature_cols = groups["full"]
    X_scaled = scaled_features(df, feature_cols)
    col_index = {c: i for i, c in enumerate(feature_cols)}
    group_idx = {
        "clinical": [col_index[c] for c in groups["clinical"] if c in col_index],
        "imaging": [col_index[c] for c in groups["imaging"] if c in col_index],
    }
    y = df["label"].values.astype(int)
    splits = list(_stratified_kfold(y, folds, seed))
    clock["prep_s"] += time.perf_counter() - t0

    scenarios = {
        "full": {"clinical": False, "imaging": False},
        "missing_clinical": {"clinical": True, "imaging": False},
        "missing_imaging": {"clinical": False, "imaging": True},
    }

    t0 = time.perf_counter()
    trees = [boosted_tree(seed + fold, num_threads) for fold in range(1, len(splits) + 1)]
    fit_boosted_trees(trees, [X_scaled[tr] for tr, _ in splits], [y[tr] for tr, _ in splits])
    clock["lgbm_s"] += time.perf_counter() - t0

    rows = []
    for fold, ((train_idx, test_idx), tree) in enumerate(zip(splits, trees), start=1):
        X_train, X_test = X_scaled[train_idx], X_scaled[test_idx]
        y_train, y_test = y[train_idx], y[test_idx]
        t0 = time.perf_counter()
        predict_mod = train_moddrop_mlp(
            X_train, y_train, group_idx, moddrop_prob, epochs, batch_size, 1e-3, seed + fold
        )
        clock["mlp_s"] += time.perf_counter() - t0

        for scen_name, drop in scenarios.items():
            X_test_masked = mask_features(X_test, group_idx, drop)
            t0 = time.perf_counter()
            p_tree = (
                tree.predict_proba(X_test_masked)[:, 1]
                if hasattr(tree, "predict_proba")
                else tree.predict(X_test_masked)
            )
            clock["lgbm_s"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            p_mod = predict_mod(X_test, drop)
            clock["mlp_s"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            # sorted: the JAX script's jitted metrics come back so
            rows.append({"model": "lgbm", "scenario": scen_name, "fold": fold,
                         **dict(sorted(compute_metrics(y_test, p_tree).items()))})
            rows.append({"model": "moddrop_mlp", "scenario": scen_name, "fold": fold,
                         **dict(sorted(compute_metrics(y_test, p_mod).items()))})
            clock["metrics_s"] += time.perf_counter() - t0

    out_df = pd.DataFrame(rows)
    out_df.to_csv(out_dir / "stress_test_per_fold.csv", index=False)
    summary = out_df.groupby(["model", "scenario"]).agg(["mean", "std"]).reset_index()
    summary.columns = [
        "_".join([c for c in col if c]) if isinstance(col, tuple) else col
        for col in summary.columns
    ]
    summary.to_csv(out_dir / "stress_test_summary.csv", index=False)
    _plot(summary, out_dir, logger)

    LAST_TIMINGS.clear()
    LAST_TIMINGS.update(clock, total_s=time.perf_counter() - t_run)
    logger.info("stage wall seconds: %s", {k: round(v, 3) for k, v in LAST_TIMINGS.items()})
    logger.info("Saved stress test summary to %s", out_dir / "stress_test_summary.csv")
    return out_df


def _plot(summary, out_dir: Path, logger):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as exc:  # matplotlib is absent on the card's machine
        logger.warning("Plot generation failed: %s", exc)
        return
    fig, ax = plt.subplots(figsize=(7, 4))
    for i, model in enumerate(summary["model"].unique()):
        subset = summary[summary["model"] == model]
        ax.bar(
            np.arange(len(subset)) + i * 0.35,
            subset["roc_auc_mean"],
            yerr=subset["roc_auc_std"],
            width=0.35,
            label=model,
            capsize=3,
        )
    ax.set_xticks(np.arange(len(subset)) + 0.35 / 2)
    ax.set_xticklabels(subset["scenario"], rotation=20, ha="right")
    ax.set_ylabel("ROC-AUC")
    ax.set_title("Stress test: clinical/imaging missingness")
    ax.set_ylim(0, 1.0)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_dir / "stress_test_roc_auc.png", dpi=300)
    fig.savefig(out_dir / "stress_test_roc_auc.pdf")
    plt.close(fig)


def main(argv=None):
    parser = argparse.ArgumentParser(description="PPMI stress test for missing clinical data")
    parser.add_argument("--input-csv", default="data/processed/ppmi/ppmi_subject_baseline.csv")
    parser.add_argument("--output-dir", default=None)
    parser.add_argument("--num-threads", type=int, default=2)
    parser.add_argument("--folds", type=int, default=5)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--epochs", type=int, default=30)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--moddrop-prob", type=float, default=0.3)
    args = parser.parse_args(argv)

    timestamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    out_dir = Path(args.output_dir or f"runs/ppmi_stress_test_{timestamp}")
    logger = setup_logging(out_dir)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS", "NUMEXPR_NUM_THREADS"):
        os.environ[var] = str(args.num_threads)

    df = pd.read_csv(args.input_csv, low_memory=False)
    return run_stress_test(
        df, out_dir, folds=args.folds, seed=args.seed, epochs=args.epochs,
        batch_size=args.batch_size, moddrop_prob=args.moddrop_prob,
        num_threads=args.num_threads, logger=logger,
    )


if __name__ == "__main__":
    main()
