"""Fused multi-seed sweeps (port of ``pd_fusion/parallel/seed_sweep.py``):
the whole (seed x fold) grid as one stacked CV.

Every seed's K folds become entries on the same stacked fold axis of
``parallel/cv_engine.py::run_parallel_cv``, so S seeds x K folds train in
one fold-batched trainer call and evaluate in one metrics reduction, where
the reference sweep submits one cluster job per (model, seed).

The host layout is the JAX module's: per seed, ``set_seed``, load the
data, split the folds and draw one (init, train) generator pair per fold
from that seed's chain, interleaved, as a standalone run draws them; then
one ``run_parallel_cv`` over all S x K folds; then one run directory
``<model>_s<seed>/`` per seed with the provenance and resolved config,
``results_fold_i.yaml``, ``preds_fold_i_full_observation.csv`` and
``results_aggregated.yaml``, which ``analysis/aggregate_results.py``
reads unchanged.

A standalone run draws its generators after its host prep, the sweep
right after the folds; no dataset loader, splitter or prep step takes a
generator from the chain, so both draw at the same position. Folds of
unequal size pad to the widest fold of all seeds (the MLP batch size
clamps to that width, the MIL batch size to the smallest fold's), so a
sweep over equal folds reproduces each standalone run and one over ragged
folds (group K-fold) need not.

Under ``torchrun`` the stacked CV shards over the (fold, data) mesh like
any CV (``parallel/cv_engine.py``); rank 0 names the sweep directory and
writes the run directories.
"""
import copy
import datetime
import logging
from pathlib import Path

import numpy as np
import pandas as pd

from pd_fusion_torch.data.splits import get_group_kfold_splits, get_kfold_splits, get_subset_masks
from pd_fusion_torch.parallel import distributed
from pd_fusion_torch.parallel.cv_engine import run_parallel_cv, supports_parallel_cv
from pd_fusion_torch.paths import RUNS_DIR
from pd_fusion_torch.utils.device import get_device
from pd_fusion_torch.utils.io import save_yaml
from pd_fusion_torch.utils.seed import fresh_generator, set_seed

logger = logging.getLogger("pd_fusion")


def run_multi_seed_cv(
    config: dict,
    data_config: dict,
    eval_config: dict,
    seeds,
    k: int,
    synthetic: bool,
    sweep_dir: Path = None,
    dataset_loader=None,
):
    """Train and evaluate K-fold CV for every seed in one stacked CV.

    ``dataset_loader(config, data_config, synthetic) -> (name, df, masks)``
    defaults to ``experiments/run_experiment.py::load_dataset``. Returns
    ({seed: aggregated results}, sweep_dir) and writes the per-seed run
    directories.
    """
    from pd_fusion_torch.experiments.run_experiment import _save_run_provenance, load_dataset
    from pd_fusion_torch.training.train import _resolve_params

    if dataset_loader is None:
        dataset_loader = load_dataset
    if not supports_parallel_cv(config):
        raise ValueError(
            "run_multi_seed_cv requires a parallel-CV-capable config "
            "(MLP/MoE family, no calibration)."
        )
    device = get_device()
    model_type = config["model_type"]
    if sweep_dir is None:
        sweep_dir = RUNS_DIR / distributed.broadcast_object(
            f"fused_sweep_{datetime.datetime.now().strftime('%Y%m%d_%H%M%S')}")
    sweep_dir = Path(sweep_dir)
    writes = distributed.is_primary()
    if writes:
        sweep_dir.mkdir(parents=True, exist_ok=True)

    group_col = config.get("group_col") or config.get("cv_group_col")

    # ---- per-seed host prep: data, folds, masks, generators ---------------
    combined_folds, combined_masks, combined_gens = [], [], []
    seed_slices, seed_meta = {}, {}
    for seed in seeds:
        cfg_s = copy.deepcopy(config)
        cfg_s["seed"] = seed
        set_seed(seed)
        dataset_name, df, masks = dataset_loader(cfg_s, data_config, synthetic)
        if group_col:
            folds = list(get_group_kfold_splits(df, n_splits=k, seed=seed, group_col=group_col))
        else:
            folds = list(get_kfold_splits(df, n_splits=k, seed=seed))
        start = len(combined_folds)
        for train_df, val_df in folds:
            combined_folds.append((train_df, val_df))
            combined_masks.append(
                (get_subset_masks(masks, train_df.index), get_subset_masks(masks, val_df.index))
            )
        # this seed's chain, interleaved (init, train) per fold: the order a
        # standalone run under the seed draws them
        combined_gens.extend((fresh_generator(), fresh_generator(device)) for _ in folds)
        seed_slices[seed] = (start, start + len(folds))
        seed_meta[seed] = (dataset_name, cfg_s)

    _resolve_params(config, model_type)
    logger.info(
        f"fused sweep: {len(seeds)} seeds x {k} folds = {len(combined_folds)} "
        f"models in one stacked CV"
    )
    metrics_all, fold_preds = run_parallel_cv(
        config, None, None, combined_folds, eval_config,
        fold_masks=combined_masks, fold_generators=combined_gens,
    )

    # ---- per-seed artifacts ---------------------------------------------
    out = {}
    for seed in seeds:
        lo, hi = seed_slices[seed]
        dataset_name, cfg_s = seed_meta[seed]
        run_dir = sweep_dir / f"{model_type}_s{seed}"
        if writes:
            run_dir.mkdir(parents=True, exist_ok=True)
            _save_run_provenance(run_dir, cfg_s, eval_config, dataset_name, synthetic,
                                 {"seed": seed})

        seed_metrics = []
        for i, fi in enumerate(range(lo, hi)):
            res = dict(metrics_all[fi])
            res["fold"] = i + 1
            seed_metrics.append(res)
            if writes:
                save_yaml(res, run_dir / f"results_fold_{i + 1}.yaml")
                y_true, y_prob = fold_preds[fi]
                pd.DataFrame(
                    {"y_true": y_true.astype(int), "y_prob": y_prob, "fold": i + 1}
                ).to_csv(run_dir / f"preds_fold_{i + 1}_full_observation.csv", index=False)

        aggregated = {}
        scenario_names = [kk for kk in seed_metrics[0] if kk != "fold"]
        for scen in scenario_names:
            aggregated[scen] = {}
            for m in seed_metrics[0][scen]:
                values = [fr[scen][m] for fr in seed_metrics]
                aggregated[scen][m] = {
                    "mean": float(np.mean(values)),
                    "std": float(np.std(values)),
                }
        if writes:
            save_yaml(aggregated, run_dir / "results_aggregated.yaml")
        out[seed] = aggregated

    logger.info(f"fused sweep complete: {sweep_dir}")
    return out, sweep_dir
