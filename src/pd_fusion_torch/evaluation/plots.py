"""Run-artifact plots (port of ``pd_fusion/evaluation/plots.py``).

Same artifact contract: five figures — scenario-degradation bars,
reliability diagram, ROC, PR, risk-coverage — and, next to every PNG, a
``.csv`` twin holding the plotted data with the same column names.

The curves' data are numpy copies of scikit-learn's ``roc_curve``,
``precision_recall_curve`` and ``calibration_curve`` (uniform bins), so
the CSV twins match the JAX package's (held against scikit-learn in the
tests). Drawing needs matplotlib; where it is not installed the PNG is
skipped with a warning and the CSV twin is still written. seaborn is
optional (bar styling only).
"""
import logging
from pathlib import Path

import numpy as np
import pandas as pd

logger = logging.getLogger("pd_fusion")


# ---------------------------------------------------------------------------
# curve data (scikit-learn's definitions)
# ---------------------------------------------------------------------------


def _counts_at_thresholds(y_true, y_score):
    """(fps, tps, thresholds) at each distinct score, descending."""
    y_true = (np.asarray(y_true).ravel() == 1).astype(np.int32)
    y_score = np.asarray(y_score).ravel()
    if not (np.all(np.isfinite(y_score)) and np.all(np.isfinite(y_true))):
        raise ValueError("curve inputs contain NaN or infinity")
    order = np.argsort(y_score, kind="stable")[::-1]
    y_score, y_true = y_score[order], y_true[order]
    distinct = np.nonzero(np.diff(y_score))[0]
    threshold_idxs = np.concatenate([distinct, [y_true.size - 1]])
    tps = np.cumsum(y_true.astype(np.float64), dtype=np.float64)[threshold_idxs]
    fps = 1 + threshold_idxs.astype(np.float64) - tps
    return fps, tps, y_score[threshold_idxs]


def roc_curve(y_true, y_score):
    """-> (fpr, tpr, thresholds), with collinear points dropped."""
    fps, tps, thresholds = _counts_at_thresholds(y_true, y_score)
    if fps.shape[0] > 2:
        keep = np.where(np.concatenate(
            [[True], np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), [True]]
        ))[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.concatenate([[0.0], tps])
    fps = np.concatenate([[0.0], fps])
    thresholds = np.concatenate([[np.inf], thresholds.astype(np.float64)])
    fpr = np.full(fps.shape, np.nan) if fps[-1] <= 0 else fps / fps[-1]
    tpr = np.full(tps.shape, np.nan) if tps[-1] <= 0 else tps / tps[-1]
    return fpr, tpr, thresholds


def precision_recall_curve(y_true, y_score):
    """-> (precision, recall, thresholds), recall decreasing (every
    threshold kept, scikit-learn's default)."""
    fps, tps, thresholds = _counts_at_thresholds(y_true, y_score)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    return (np.concatenate([precision[::-1], [1.0]]),
            np.concatenate([recall[::-1], [0.0]]), thresholds[::-1])


def calibration_curve(y_true, y_prob, n_bins: int = 10):
    """-> (prob_true, prob_pred) over uniform bins, empty bins dropped."""
    y_true = np.asarray(y_true).ravel() == 1
    y_prob = np.asarray(y_prob).ravel()
    if y_prob.min() < 0 or y_prob.max() > 1:
        raise ValueError("y_prob has values outside [0, 1].")
    bins = np.linspace(0.0, 1.0, n_bins + 1)
    binids = np.searchsorted(bins[1:-1], y_prob)
    bin_sums = np.bincount(binids, weights=y_prob, minlength=n_bins)
    bin_true = np.bincount(binids, weights=y_true, minlength=n_bins)
    bin_total = np.bincount(binids, minlength=n_bins)
    nonzero = bin_total != 0
    return bin_true[nonzero] / bin_total[nonzero], bin_sums[nonzero] / bin_total[nonzero]


# ---------------------------------------------------------------------------
# figures
# ---------------------------------------------------------------------------


def save_plot_data(df: pd.DataFrame, output_path: Path):
    """Write a figure's underlying data (the CSV half of the contract)."""
    df.to_csv(output_path, index=False)


def _draw(output_path: Path, draw, *, title, xlabel=None, ylabel=None, square=False,
          grid=True):
    """One finished figure: ``draw(ax, plt)`` then title/save/close. No-op
    with a warning when matplotlib is not installed."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        logger.warning(f"matplotlib is not installed; skipping {Path(output_path).name}")
        return
    fig, ax = plt.subplots(figsize=(6, 6) if square else (10, 6))
    try:
        draw(ax)
        ax.set_title(title)
        if xlabel:
            ax.set_xlabel(xlabel)
        if ylabel:
            ax.set_ylabel(ylabel)
        if grid:
            ax.grid(True, alpha=0.3)
        fig.tight_layout()
        fig.savefig(output_path)
    finally:
        plt.close(fig)


def plot_degradation_curve(results: dict, output_path: Path):
    """ROC/PR-AUC per missingness scenario, as a bar chart."""
    rows = pd.DataFrame(
        {
            "Scenario": list(results),
            "ROC-AUC": [m["roc_auc"] for m in results.values()],
            "PR-AUC": [m["pr_auc"] for m in results.values()],
        }
    )
    save_plot_data(rows, output_path.with_suffix(".csv"))

    def draw(ax):
        try:
            import seaborn as sns
        except ImportError:  # optional styling dep
            sns = None
        if sns is not None:
            sns.barplot(data=rows, x="Scenario", y="ROC-AUC", hue="Scenario", ax=ax)
        else:
            ax.bar(rows["Scenario"], rows["ROC-AUC"])
        ax.tick_params(axis="x", rotation=45)
        for lbl in ax.get_xticklabels():
            lbl.set_horizontalalignment("right")

    _draw(output_path, draw, title="Model Robustness: ROC-AUC vs Missingness Scenario",
          ylabel="ROC-AUC", grid=False)


def plot_calibration_curve_func(y_true, y_prob, output_path: Path, model_name="Model"):
    """Reliability diagram over 10 equal-width probability bins."""
    frac_pos, mean_pred = calibration_curve(y_true, y_prob, n_bins=10)
    save_plot_data(
        pd.DataFrame(
            {"Mean_Predicted_Probability": mean_pred, "Fraction_of_Positives": frac_pos}
        ),
        output_path.with_suffix(".csv"),
    )

    def draw(ax):
        ax.plot(mean_pred, frac_pos, marker="o", label=model_name)
        ax.plot([0, 1], [0, 1], "k--", label="Perfectly Calibrated")
        ax.legend()

    _draw(output_path, draw, title=f"Reliability Diagram ({model_name})",
          xlabel="Mean Predicted Probability", ylabel="Fraction of Positives", square=True)


def plot_roc_curve(y_true, y_prob, output_path: Path):
    fpr, tpr, _ = roc_curve(y_true, y_prob)
    save_plot_data(pd.DataFrame({"FPR": fpr, "TPR": tpr}), output_path.with_suffix(".csv"))

    def draw(ax):
        ax.plot(fpr, tpr, label="ROC Curve")
        ax.plot([0, 1], [0, 1], "k--")

    _draw(output_path, draw, title="ROC Curve", xlabel="False Positive Rate",
          ylabel="True Positive Rate", square=True)


def plot_pr_curve(y_true, y_prob, output_path: Path):
    precision, recall, _ = precision_recall_curve(y_true, y_prob)
    save_plot_data(
        pd.DataFrame({"Recall": recall, "Precision": precision}),
        output_path.with_suffix(".csv"),
    )
    _draw(output_path, lambda ax: ax.plot(recall, precision, label="PR Curve"),
          title="Precision-Recall Curve", xlabel="Recall", ylabel="Precision", square=True)


def plot_risk_coverage(data: dict, output_path: Path):
    """Selective-prediction curve: error rate among covered samples."""
    save_plot_data(
        pd.DataFrame({"Coverage": data["coverage"], "Risk": data["risk"]}),
        output_path.with_suffix(".csv"),
    )

    def draw(ax):
        ax.plot(data["coverage"], data["risk"], label="Risk-Coverage")
        ax.set_xlim(0, 1)
        ax.legend()

    _draw(output_path, draw, title="Risk-Coverage Curve",
          xlabel="Coverage (Fraction of samples predicted)",
          ylabel="Risk (Error Rate)", square=True)
