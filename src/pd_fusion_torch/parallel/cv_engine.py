"""K-fold cross-validation engine (port of
``pd_fusion/parallel/cv_engine.py``, without its multi-device mesh).

The JAX package trains all folds as one ``vmap``-ed program over a fold
axis. The port keeps that program's inputs exactly: every fold's training
set is padded to the largest fold with zero row weights (padding rows
join the shuffle and the batch count, as in the JAX program), eval /
calibration sets are padded to shared widths, and each fold draws its
generators in the JAX package's order.

- MLP families (``fusion_late``, ``fusion_masked``, ``fusion_moddrop``,
  ``unimodal_mlp``): the fold axis is a batch dimension. Params are
  stacked [K, in, out] and one Adam trains all folds
  (``nn/trainer.py``); the eval inputs are [K, S, Nv, F'], one forward for
  every fold and scenario.
- ``moe``: stacked-expert params [K, M, in, out], inputs [K, M, N, Fmax],
  one full-batch Adam over all folds (``nn/moe.py``); every fold and
  scenario in one forward.
- ``unimodal_gbdt`` on the device backend: per-fold host binning, then
  every fold's ensemble grows at once (``nn/gbdt.py``, bins [K, N, F]).
- MIL: the folds loop in Python; every forward through the MIL head pools
  with the CUDA kernel K1 on the card.

The tail is the JAX package's: per-scenario probabilities (for MIL,
assembled from the kept-bag probabilities, ``missing_prob`` for absent or
masked bags), isotonic calibration per fold, then all K x S metric sets
packed into one buffer and fetched once. Calibration runs on the device
(``ops/isotonic.py``, fit and transform of every fold at once) unless a
calibration set is larger than ``MAX_DEVICE_N`` or
``PD_FUSION_HOST_ISOTONIC=1``; then, and always for MIL, it is the host
fit per fold. ``isotonic_arms`` counts which arm each calibrated run took.
"""
import logging
import os
from typing import List, Tuple

import numpy as np
import torch

from pd_fusion_torch.data.feature_utils import (
    apply_modality_masks_np,
    feature_modality_matrix,
    get_all_feature_cols,
    get_modality_feature_cols,
)
from pd_fusion_torch.data.missingness import apply_missingness_scenario, get_modality_mask_matrix
from pd_fusion_torch.data.preprocess import preprocess_features
from pd_fusion_torch.data.schema import MODALITIES, TARGET_COL
from pd_fusion_torch.data.splits import get_subset_masks
from pd_fusion_torch.ops import isotonic as dev_isotonic
from pd_fusion_torch.ops import metrics as dev_metrics
from pd_fusion_torch.utils.device import get_device
from pd_fusion_torch.utils.seed import fresh_generator

PARALLEL_CV_FAMILIES = {
    "fusion_late", "fusion_masked", "fusion_moddrop", "unimodal_mlp", "moe", "mil_attention",
}

logger = logging.getLogger("pd_fusion")

# calibrated CV runs per isotonic arm, since import
isotonic_arms = {"device": 0, "host": 0}


def gbdt_device_backend(config) -> bool:
    """True when ``unimodal_gbdt`` resolves to the device trainer
    (``nn/gbdt.py::resolve_gbdt_backend``); only then are the folds a batch
    dimension, and the host backend keeps the fold-by-fold path."""
    from pd_fusion_torch.nn.gbdt import resolve_gbdt_backend

    return resolve_gbdt_backend(config.get("params", {}).get("backend")) == "device"


def supports_parallel_cv(config) -> bool:
    if config.get("parallel_cv", True) is False:
        return False
    if config.get("model_type") == "unimodal_gbdt":
        return gbdt_device_backend(config)
    return config.get("model_type") in PARALLEL_CV_FAMILIES


# all K x S metric sets of probs [K, S, N], packed with the probs into one
# fetchable buffer (the JAX engine's name for it)
_metrics_from_probs_packed = dev_metrics.binary_metrics_packed


def run_parallel_cv(config, df, masks, folds, eval_config):
    """Train + evaluate all folds.

    Returns (metrics_all, fold_preds):
      metrics_all: list of per-fold {scenario: {metric: float}} dicts
      fold_preds:  list of (y_true, y_prob) for the full_observation
                   scenario per fold (for preds_fold_i CSVs).
    """
    model_type = config["model_type"]
    scenarios = eval_config.get("scenarios", [{"name": "baseline", "drop_modalities": []}])
    group_col = eval_config.get("group_col")
    K = len(folds)

    # ---- calibration plumbing (isotonic) ---------------------------------
    do_calibrate = bool(config.get("calibrate", False))
    nested = do_calibrate and bool(config.get("nested_calibration", False))
    calib_dfs: List = [None] * K
    if nested:
        from pd_fusion_torch.data.splits import split_train_calibration

        seed = config.get("seed", 42)
        calib_size = float(config.get("calibration_split", 0.2))
        new_folds, calib_dfs = [], []
        for train_df, val_df in folds:
            reduced, calib_df = split_train_calibration(
                train_df, calib_size=calib_size, seed=seed, group_col=group_col
            )
            new_folds.append((reduced, val_df))
            calib_dfs.append(calib_df)
        folds = new_folds

    run = {"mil_attention": _run_parallel_cv_mil, "unimodal_gbdt": _run_parallel_cv_gbdt,
           "moe": _run_parallel_cv_moe}.get(model_type, _run_parallel_cv_mlp)
    return run(config, folds, masks, scenarios, group_col, calib_dfs, do_calibrate, nested)


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def _pad_stack(arrays: List[np.ndarray], pad_value=0.0) -> Tuple[np.ndarray, np.ndarray]:
    """Stack unequal-length [N_i, ...] arrays into [K, N_max, ...] plus a
    [K, N_max] validity-weight matrix."""
    n_max = max(a.shape[0] for a in arrays)
    K = len(arrays)
    out = np.full((K, n_max) + arrays[0].shape[1:], pad_value, dtype=np.float32)
    w = np.zeros((K, n_max), dtype=np.float32)
    for i, a in enumerate(arrays):
        out[i, : a.shape[0]] = a
        w[i, : a.shape[0]] = 1.0
    return out, w


def _eval_targets(yva_list, S):
    """[K, S, Nv_max] labels and weights (zero on the padding)."""
    yv, wv = _pad_stack([y[:, None] for y in yva_list])
    return (np.repeat(yv[..., 0][:, None, :], S, axis=1),
            np.repeat(wv[:, None, :], S, axis=1))


def _pad_cal_targets(ycal_list, device=None):
    """[K, Nc_max] labels + validity mask for the device isotonic fit."""
    K = len(ycal_list)
    nc_max = max(len(y) for y in ycal_list)
    ycal = np.zeros((K, nc_max), np.float32)
    calmask = np.zeros((K, nc_max), bool)
    for i, y in enumerate(ycal_list):
        ycal[i, : len(y)] = y
        calmask[i, : len(y)] = True
    return torch.as_tensor(ycal, device=device), torch.as_tensor(calmask, device=device)


def _use_device_isotonic(ycal_list) -> bool:
    """Device isotonic is the default; the host fit covers calibration
    sets larger than ``MAX_DEVICE_N`` (the max-min lowering builds Nc^2
    buffers) and ``PD_FUSION_HOST_ISOTONIC=1`` for A/B."""
    if os.environ.get("PD_FUSION_HOST_ISOTONIC") == "1":
        return False
    return max(len(y) for y in ycal_list) <= dev_isotonic.MAX_DEVICE_N


def _iso_cal_metrics_pack(probs_scen, probs_cal, ycal, calmask, yv, wv):
    """Device isotonic calibration (fit per fold on the calibration probs
    [K, Nc], transform every fold x scenario prob [K, S, Nv]) + all K x S
    metrics, packed."""
    K, S, nv = probs_scen.shape
    calibrated = dev_isotonic.isotonic_fit_transform(
        probs_cal, ycal, calmask, probs_scen.reshape(K, S * nv)).reshape(K, S, nv)
    return _metrics_from_probs_packed(calibrated, yv, wv)


def _fit_isotonic_per_fold(cal_probs, cal_y, n_cal):
    """K host isotonic fits on the calibration probs (scikit-learn's
    ``IsotonicRegression(out_of_bounds="clip")``, as the JAX package's
    host arm; the port's numpy copy)."""
    from pd_fusion_torch.models.calibrate import IsotonicRegression

    return [IsotonicRegression().fit(cal_probs[i, : n_cal[i]], cal_y[i][: n_cal[i]])
            for i in range(len(n_cal))]


def _scen_cal_buffer(probs_scen, probs_cal):
    """[K, S*Nv + Nc] buffer: scenario probs then calibration-set probs."""
    return torch.cat([probs_scen.reshape(probs_scen.shape[0], -1), probs_cal], dim=1)


def _calibrated_pack(probs_scen, probs_cal, ycal_list, yv, wv):
    """The calibrated tail of every tabular family: raw scenario probs
    [K, S, Nv] and calibration-set probs [K, Nc] (padded) -> packed
    metrics and calibrated probs, on the device arm or the host arm."""
    dev = probs_scen.device
    if _use_device_isotonic(ycal_list):
        isotonic_arms["device"] += 1
        ycal, calmask = _pad_cal_targets(ycal_list, dev)
        return _iso_cal_metrics_pack(probs_scen, probs_cal, ycal, calmask, yv, wv)
    isotonic_arms["host"] += 1
    K, S, nv = probs_scen.shape
    buf = _scen_cal_buffer(probs_scen, probs_cal).cpu().numpy()
    raw = buf[:, : S * nv].reshape(K, S, nv)
    calibrators = _fit_isotonic_per_fold(buf[:, S * nv:], ycal_list, [len(y) for y in ycal_list])
    calibrated = np.empty_like(raw)
    for i, iso in enumerate(calibrators):
        calibrated[i] = iso.transform(raw[i].ravel()).reshape(S, nv)
    return _metrics_from_probs_packed(torch.as_tensor(calibrated, device=dev), yv, wv)


def _fold_results(packed, scenarios, group_col, val_dfs, yva_list):
    """The packed [K, S] metrics and [K, S, Nv_max] probs -> per-fold
    {scenario: metrics} dicts (plus subject-level metrics with a group
    column) and each fold's full-observation (y_true, y_prob)."""
    K, S = len(val_dfs), len(scenarios)
    nv_max = max(len(y) for y in yva_list)
    md, probs = dev_metrics.unpack_metrics_and_probs(packed, (K, S), (K, S, nv_max))
    full_obs_idx = next(
        (i for i, s in enumerate(scenarios) if s["name"] == "full_observation"), 0
    )
    metrics_all, fold_preds = [], []
    for i, val_df in enumerate(val_dfs):
        n_i = len(yva_list[i])
        res = {}
        for si, scenario in enumerate(scenarios):
            m = {k: float(md[k][i, si]) for k in md}
            if group_col and group_col in val_df.columns:
                from pd_fusion_torch.evaluation.evaluate import _subject_metrics

                subj = _subject_metrics(
                    val_df, group_col, yva_list[i].astype(int), probs[i, si, :n_i]
                )
                for kk, vv in subj.items():
                    m[f"subject_{kk}"] = vv
            res[scenario["name"]] = m
        metrics_all.append(res)
        fold_preds.append((yva_list[i], probs[i, full_obs_idx, :n_i]))
    return metrics_all, fold_preds


# ---------------------------------------------------------------------------
# MLP families: folds as a batch dimension
# ---------------------------------------------------------------------------


def _stack_params(param_list):
    """K single-model params -> one fold-stacked params list."""
    return [{k: torch.stack([p[li][k] for p in param_list]) for k in param_list[0][li]}
            for li in range(len(param_list[0]))]


def _init_folds_mlp(init_gens, dims, device):
    """All folds' MLP params, stacked (the same draws as per-fold
    ``mlp_init`` calls with the same generators)."""
    from pd_fusion_torch.nn.mlp import mlp_init

    return _stack_params([mlp_init(g, dims, device=device) for g in init_gens])


def _packed_mlp_eval(trained, Xs, yv, wv):
    """Probs of every fold and scenario (stacked params, eval inputs
    [K, S, Nv, F']) + all K x S metric sets, packed into one buffer (one
    device -> host copy)."""
    from pd_fusion_torch.nn.trainer import predict_proba

    return _metrics_from_probs_packed(predict_proba(trained, Xs), yv, wv)


def _probs_scen_cal(trained, Xs, Xc):
    """Raw scenario probs [K, S, Nv] + calibration-set probs [K, Nc]."""
    from pd_fusion_torch.nn.trainer import predict_proba

    return predict_proba(trained, Xs), predict_proba(trained, Xc)


def _probs_with_calib(trained, Xs, Xc):
    """[K, S*Nv + Nc] buffer: scenario probs then calibration-set probs."""
    return _scen_cal_buffer(*_probs_scen_cal(trained, Xs, Xc))


def _run_parallel_cv_mlp(config, folds, masks, scenarios, group_col, calib_dfs,
                         do_calibrate, nested):
    from pd_fusion_torch.models.fusion_moddrop import _assignment_matrix
    from pd_fusion_torch.nn.trainer import fullbatch_impl, minibatch_moddrop_impl

    device = get_device()
    model_type = config["model_type"]
    params_cfg = config["params"]
    K = len(folds)

    # ---- per-fold host prep (scaler fits; tiny) --------------------------
    all_features = get_all_feature_cols(folds[0][0])
    if model_type == "unimodal_mlp":
        feat_cols = get_modality_feature_cols(folds[0][0], config.get("modality", "clinical"))
    else:
        feat_cols = all_features
    if not feat_cols:
        raise ValueError("No feature columns for parallel CV.")
    mod_dims = {m: len(get_modality_feature_cols(folds[0][0], m)) for m in MODALITIES}
    masked = model_type == "fusion_masked"
    assign = feature_modality_matrix(feat_cols)

    Xtr_list, ytr_list, Xva_scen_list, yva_list = [], [], [], []
    Xcal_list, ycal_list = [], []  # calibration-set inputs (do_calibrate only)
    for fi, (train_df, val_df) in enumerate(folds):
        train_masks = get_subset_masks(masks, train_df.index)
        val_masks = get_subset_masks(masks, val_df.index)
        X_tr, _, scaler = preprocess_features(train_df, feat_cols)
        X_va_raw, _, _ = preprocess_features(val_df, feat_cols, None, scaler)
        if masked:
            X_tr = np.concatenate([X_tr, get_modality_mask_matrix(train_masks).astype(np.float32)],
                                  axis=1)
        Xtr_list.append(X_tr.astype(np.float32))
        ytr_list.append(train_df[TARGET_COL].values.astype(np.float32))

        if do_calibrate:
            # the sequential path's calibration input: the RAW preprocessed
            # matrix (no scenario zeroing), natural-mask concat for masked
            # fusion; nested uses the carved calibration split
            if nested:
                cal_df = calib_dfs[fi]
                cal_masks = get_subset_masks(masks, cal_df.index)
                X_cal, _, _ = preprocess_features(cal_df, feat_cols, None, scaler)
            else:
                cal_df, cal_masks, X_cal = val_df, val_masks, X_va_raw
            if masked:
                X_cal = np.concatenate(
                    [X_cal, get_modality_mask_matrix(cal_masks).astype(np.float32)], axis=1)
            Xcal_list.append(X_cal.astype(np.float32))
            ycal_list.append(cal_df[TARGET_COL].values.astype(np.float32))

        # scenario-transformed eval inputs for this fold (scenario draws
        # come from numpy's global RNG in the JAX package's order)
        scen_X = []
        for scenario in scenarios:
            mm = get_modality_mask_matrix(
                apply_missingness_scenario(val_df, scenario, val_masks)).astype(np.float32)
            Xs = apply_modality_masks_np(X_va_raw, mm, assign)
            if masked:
                Xs = np.concatenate([Xs, mm], axis=1)
            scen_X.append(Xs.astype(np.float32))
        Xva_scen_list.append(np.stack(scen_X))  # [S, Nv, F']
        yva_list.append(val_df[TARGET_COL].values.astype(np.float32))

    # ---- stack + train ----------------------------------------------------
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    X_stack, w_tr = _pad_stack(Xtr_list)
    y_stack = _pad_stack([y[:, None] for y in ytr_list])[0][..., 0]
    dims = [X_stack.shape[-1], *params_cfg["hidden_dims"], 1]
    # interleaved (init, train) draws per fold: the sequential fold loop's
    # order on the global chain
    gens = [(fresh_generator(), fresh_generator(device)) for _ in range(K)]
    params_stack = _init_folds_mlp([g for g, _ in gens], dims, device)
    train_gens = [g for _, g in gens]

    lr = float(params_cfg["lr"])
    epochs = int(params_cfg["epochs"])
    dropout = float(params_cfg.get("dropout", 0.2))
    wd = float(params_cfg.get("weight_decay", 0.0))
    if model_type == "fusion_moddrop":
        assign_md, _ = _assignment_matrix(mod_dims)
        trained = minibatch_moddrop_impl(
            params_stack, t(X_stack), t(y_stack), t(w_tr), t(assign_md), train_gens, lr, epochs,
            # clamped to the PADDED width, as the JAX program's one static
            # batch size for all folds
            min(int(params_cfg.get("batch_size", 32)), X_stack.shape[1]),
            dropout, wd, float(params_cfg.get("moddrop_rate", 0.2)),
            bool(params_cfg.get("moddrop_per_sample", False)),
        )
    else:
        trained = fullbatch_impl(params_stack, t(X_stack), t(y_stack), t(w_tr), train_gens, lr,
                                 epochs, dropout, wd)

    # ---- all folds x scenarios: one forward, one packed fetch -------------
    nv_max = max(a.shape[1] for a in Xva_scen_list)
    Xs_stack = np.zeros((K, len(scenarios), nv_max, Xva_scen_list[0].shape[2]), np.float32)
    for i, a in enumerate(Xva_scen_list):
        Xs_stack[i, :, : a.shape[1], :] = a
    yv_rep, wv_rep = _eval_targets(yva_list, len(scenarios))

    if do_calibrate:
        probs_scen, probs_cal = _probs_scen_cal(trained, t(Xs_stack), t(_pad_stack(Xcal_list)[0]))
        packed = _calibrated_pack(probs_scen, probs_cal, ycal_list, t(yv_rep), t(wv_rep))
    else:
        packed = _packed_mlp_eval(trained, t(Xs_stack), t(yv_rep), t(wv_rep))
    return _fold_results(packed.cpu().numpy(), scenarios, group_col, [v for _, v in folds],
                         yva_list)


# ---------------------------------------------------------------------------
# MoE: folds as a batch dimension
# ---------------------------------------------------------------------------


def _init_folds_moe(init_gens, dims, expert_hidden, router_hidden, device):
    """All folds' MoE params, stacked (the same draws as per-fold
    ``moe_init`` calls with the same generators)."""
    from pd_fusion_torch.nn.moe import moe_init

    per_fold = [moe_init(g, dims, expert_hidden, router_hidden, device=device) for g in init_gens]
    return {part: _stack_params([p[part] for p in per_fold]) for part in ("experts", "router")}


def _moe_prep_fold(train_df, val_df, cal_df):
    """Per-modality preprocessed matrices of one fold: (train, val, cal or
    None, dims). A modality without features is left out, as in the
    sequential path."""
    Xd_tr, Xd_va, Xd_cal, dims = {}, {}, {}, {}
    for mod in MODALITIES:
        feats = get_modality_feature_cols(train_df, mod)
        if not feats:
            continue
        Xd_tr[mod], _, scaler = preprocess_features(train_df, feats)
        Xd_va[mod] = preprocess_features(val_df, feats, None, scaler)[0]
        if cal_df is not None:
            Xd_cal[mod] = preprocess_features(cal_df, feats, None, scaler)[0]
        dims[mod] = len(feats)
    return Xd_tr, Xd_va, (Xd_cal if cal_df is not None else None), dims


def _run_parallel_cv_moe(config, folds, masks, scenarios, group_col, calib_dfs,
                         do_calibrate, nested):
    """Stacked MoE CV: [K, M, N, Fmax] inputs, one fold-batched trainer.
    Scenario inputs zero the masked modalities' blocks (the sequential
    ``predict_for_masks``); calibration inputs are the un-zeroed matrices
    with natural routing masks (the sequential calibration wrapper's)."""
    from pd_fusion_torch.nn.moe import map_params, moe_apply, train_moe_folds

    device = get_device()
    params_cfg = config["params"]
    K, S = len(folds), len(scenarios)
    fold_data, ytr_list, yva_list, ycal_list = [], [], [], []
    for fi, (train_df, val_df) in enumerate(folds):
        cal_df = calib_dfs[fi] if nested else None
        fold_data.append(_moe_prep_fold(train_df, val_df, cal_df))
        ytr_list.append(train_df[TARGET_COL].values.astype(np.float32))
        yva_list.append(val_df[TARGET_COL].values.astype(np.float32))
        if do_calibrate:
            ycal_list.append(cal_df[TARGET_COL].values.astype(np.float32) if nested
                             else yva_list[-1])
    dims = fold_data[0][3]
    mods = sorted(dims)
    f_max = max(dims.values())
    M = len(mods)

    def stack_dict(Xd, n):
        x = np.zeros((M, n, f_max), np.float32)
        for mi, mod in enumerate(mods):
            x[mi, :, : Xd[mod].shape[1]] = Xd[mod]
        return x

    def mask_matrix(m):
        return np.stack([m[mod] for mod in mods], axis=1).astype(np.float32)

    n_tr_max = max(len(y) for y in ytr_list)
    n_va_max = max(len(y) for y in yva_list)
    x_tr = np.zeros((K, M, n_tr_max, f_max), np.float32)
    m_tr = np.zeros((K, n_tr_max, M), np.float32)
    y_tr = np.zeros((K, n_tr_max), np.float32)
    w_tr = np.zeros((K, n_tr_max), np.float32)
    x_va = np.zeros((K, S, M, n_va_max, f_max), np.float32)
    m_va = np.zeros((K, S, n_va_max, M), np.float32)
    for i, ((train_df, val_df), (Xd_tr, Xd_va, _, _)) in enumerate(zip(folds, fold_data)):
        n_i, nv = len(ytr_list[i]), len(yva_list[i])
        x_tr[i, :, :n_i] = stack_dict(Xd_tr, n_i)
        m_tr[i, :n_i] = mask_matrix(get_subset_masks(masks, train_df.index))
        y_tr[i, :n_i] = ytr_list[i]
        w_tr[i, :n_i] = 1.0
        val_masks = get_subset_masks(masks, val_df.index)
        for si, scenario in enumerate(scenarios):
            mm = mask_matrix(apply_missingness_scenario(val_df, scenario, val_masks))
            # per-modality zeroing of the masked inputs
            x_va[i, si, :, :nv] = stack_dict(Xd_va, nv) * mm.T[:, :, None]
            m_va[i, si, :nv] = mm
    yv_rep, wv_rep = _eval_targets(yva_list, S)

    # one init generator per fold (MoE training draws nothing)
    params_stack = _init_folds_moe([fresh_generator() for _ in range(K)], dims,
                                   params_cfg["expert_hidden_dims"],
                                   params_cfg["router_hidden_dims"], device)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    trained = train_moe_folds(params_stack, t(x_tr), t(m_tr), t(y_tr), t(w_tr),
                              float(params_cfg["lr"]), int(params_cfg["epochs"]),
                              float(params_cfg.get("weight_decay", 0.0)))
    with torch.no_grad():
        # [K, 1, ...] params broadcast over the scenario axis
        probs_scen = moe_apply(map_params(trained, lambda v: v[:, None]), t(x_va), t(m_va))
        if do_calibrate:
            nc_max = max(len(y) for y in ycal_list)
            x_cal = np.zeros((K, M, nc_max, f_max), np.float32)
            m_cal = np.zeros((K, nc_max, M), np.float32)
            for i, ((_, val_df), (_, Xd_va, Xd_cal, _)) in enumerate(zip(folds, fold_data)):
                nc = len(ycal_list[i])
                cal_df = calib_dfs[i] if nested else val_df
                x_cal[i, :, :nc] = stack_dict(Xd_cal if nested else Xd_va, nc)
                m_cal[i, :nc] = mask_matrix(get_subset_masks(masks, cal_df.index))
            probs_cal = moe_apply(trained, t(x_cal), t(m_cal))
            packed = _calibrated_pack(probs_scen, probs_cal, ycal_list, t(yv_rep), t(wv_rep))
        else:
            packed = _metrics_from_probs_packed(probs_scen, t(yv_rep), t(wv_rep))
    return _fold_results(packed.cpu().numpy(), scenarios, group_col, [v for _, v in folds],
                         yva_list)


# ---------------------------------------------------------------------------
# device GBDT: every fold's ensemble at once
# ---------------------------------------------------------------------------


def _run_parallel_cv_gbdt(config, folds, masks, scenarios, group_col, calib_dfs,
                          do_calibrate, nested):
    """Stacked device-GBDT CV: per-fold host binning (quantile edges fit on
    each fold's own scaled train matrix, as the sequential
    ``DeviceHistGBDT.fit``), then every fold's ensemble grows at once and
    one traversal scores all folds x scenarios. Padding rows carry zero
    sample weight, which the trainer ignores exactly. Scenario inputs are
    the scaled val matrix with the masked modality blocks zeroed, then
    binned with the fold's edges (``evaluate.predict_for_masks``);
    calibration inputs are the un-zeroed matrix."""
    from pd_fusion_torch.models.unimodal_gbdt import _DEVICE_PARAM_KEYS
    from pd_fusion_torch.nn.gbdt import (
        DeviceHistGBDT,
        bin_features,
        compute_base_score,
        fit_bin_edges,
        predict_margin,
        train_gbdt,
    )

    device = get_device()
    proto = DeviceHistGBDT(
        **{k: v for k, v in config["params"].items() if k in _DEVICE_PARAM_KEYS})
    feat_cols = get_modality_feature_cols(folds[0][0], config.get("modality", "clinical"))
    if not feat_cols:
        raise ValueError("No feature columns for parallel GBDT CV.")
    assign = feature_modality_matrix(feat_cols)
    K, S, f_dim = len(folds), len(scenarios), len(feat_cols)

    bins_tr_list, y_tr_list, bases = [], [], []
    bins_scen_list, yva_list, bins_cal_list, ycal_list = [], [], [], []
    for fi, (train_df, val_df) in enumerate(folds):
        val_masks = get_subset_masks(masks, val_df.index)
        X_tr, _, scaler = preprocess_features(train_df, feat_cols)
        X_va_raw, _, _ = preprocess_features(val_df, feat_cols, None, scaler)
        X_tr = X_tr.astype(np.float32)
        edges = fit_bin_edges(X_tr)
        bins_tr_list.append(bin_features(X_tr, edges))
        y = train_df[TARGET_COL].values.astype(np.float32)
        y_tr_list.append(y)
        bases.append(compute_base_score(y))
        scen_b = []
        for scenario in scenarios:
            mm = get_modality_mask_matrix(
                apply_missingness_scenario(val_df, scenario, val_masks)).astype(np.float32)
            scen_b.append(bin_features(apply_modality_masks_np(X_va_raw, mm, assign), edges))
        bins_scen_list.append(np.stack(scen_b))  # [S, Nv, F]
        yva_list.append(val_df[TARGET_COL].values.astype(np.float32))
        if do_calibrate:
            if nested:
                X_cal = preprocess_features(calib_dfs[fi], feat_cols, None, scaler)[0]
                ycal_list.append(calib_dfs[fi][TARGET_COL].values.astype(np.float32))
            else:
                X_cal = X_va_raw
                ycal_list.append(yva_list[-1])
            bins_cal_list.append(bin_features(X_cal.astype(np.float32), edges))

    n_max = max(len(y) for y in y_tr_list)
    bins_tr = np.zeros((K, n_max, f_dim), np.int32)
    y_tr = np.zeros((K, n_max), np.float32)
    w_tr = np.zeros((K, n_max), np.float32)
    for i, (b, y) in enumerate(zip(bins_tr_list, y_tr_list)):
        bins_tr[i, : len(y)] = b
        y_tr[i, : len(y)] = y
        w_tr[i, : len(y)] = 1.0
    # the rows to score, one block per fold: every scenario's val rows,
    # then the calibration rows
    nv_max = max(len(y) for y in yva_list)
    nc_max = max(len(y) for y in ycal_list) if do_calibrate else 0
    bins_ev = np.zeros((K, S * nv_max + nc_max, f_dim), np.int32)
    for i, a in enumerate(bins_scen_list):
        bins_ev[i, : S * nv_max].reshape(S, nv_max, f_dim)[:, : a.shape[1]] = a
        if do_calibrate:
            bins_ev[i, S * nv_max: S * nv_max + len(ycal_list[i])] = bins_cal_list[i]
    yv_rep, wv_rep = _eval_targets(yva_list, S)

    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    base = t(np.array(bases, np.float32))
    trees = train_gbdt(t(bins_tr), t(y_tr), t(w_tr), base, **proto.hparams())
    probs = torch.sigmoid(predict_margin(trees, t(bins_ev), base, depth=proto.max_depth))
    probs_scen = probs[:, : S * nv_max].reshape(K, S, nv_max)
    if do_calibrate:
        packed = _calibrated_pack(probs_scen, probs[:, S * nv_max:], ycal_list, t(yv_rep),
                                  t(wv_rep))
    else:
        packed = _metrics_from_probs_packed(probs_scen, t(yv_rep), t(wv_rep))
    return _fold_results(packed.cpu().numpy(), scenarios, group_col, [v for _, v in folds],
                         yva_list)


# ---------------------------------------------------------------------------
# MIL: folds loop in Python
# ---------------------------------------------------------------------------


def _pad_kept_bags(bags, keep, max_len, input_dim, width):
    """Pad the kept bags of one fold into fixed [width, max_len, D] (+mask)."""
    from pd_fusion_torch.nn.mil import pad_bags

    X = np.zeros((width, max_len, input_dim), np.float32)
    M = np.zeros((width, max_len), np.float32)
    if keep:
        xb, mb = pad_bags([np.asarray(bags[j], np.float32) for j in keep], max_len)
        X[: len(keep)], M[: len(keep)] = xb, mb
    return X, M


def _assemble_mil_scenario_probs(fold_rows, kept_probs, scenarios, missing_prob):
    """Per-scenario probability vectors from the kept-bag probs: a subject
    predicts missing_prob when its bag is absent OR the scenario drops /
    the natural mask zeroes the mri modality (MilAttentionModel.
    predict_proba semantics). Scenario draws come from the numpy global
    RNG in the JAX package's order."""
    K = len(fold_rows)
    S = len(scenarios)
    nv_max = max(len(r["y_va"]) for r in fold_rows)
    probs = np.full((K, S, nv_max), missing_prob, np.float32)
    yv = np.zeros((K, S, nv_max), np.float32)
    wv = np.zeros((K, S, nv_max), np.float32)
    for i, r in enumerate(fold_rows):
        nv = len(r["y_va"])
        pos_of = {row: slot for slot, row in enumerate(r["keep_va"])}
        for si, scenario in enumerate(scenarios):
            cur = apply_missingness_scenario(r["val_df"], scenario, r["val_masks"])
            mri = cur.get("mri")
            vec = np.full(nv, missing_prob, np.float32)
            for row, slot in pos_of.items():
                if mri is None or mri[row] != 0:
                    vec[row] = kept_probs[i, slot]
            probs[i, si, :nv] = vec
            yv[i, si, :nv] = r["y_va"]
            wv[i, si, :nv] = 1.0
    return probs, yv, wv, nv_max


def _train_predict_folds(arrays, gens, hp, device):
    """Train each fold's MIL head and return the kept val + calibration
    probs, [K, nv_w + nc_w] numpy (the JAX program's output buffer)."""
    from pd_fusion_torch.nn.mil import mil_apply, mil_init, train_mil_impl

    K = arrays["X"].shape[0]
    out = []
    for i in range(K):
        t = {k: torch.as_tensor(v[i], device=device) for k, v in arrays.items()}
        init_gen, train_gen = gens[i]
        p0 = mil_init(init_gen, hp["input_dim"], hp["hidden_dim"], hp["attn_dim"],
                      hp["gated"], device=device)
        trained = train_mil_impl(
            p0, t["X"], t["BM"], t["Y"], t["WR"], t["Xt"], t["Mt"], t["Yt"], t["Wt"],
            train_gen, hp["lr"], float(t["pos_w"]), hp["max_grad_norm"], hp["epochs"],
            hp["batch_size"], hp["gated"], hp["dropout"], hp["weight_decay"],
            hp["use_clip"], hp["track_best"], hp["patience"],
            vmiss=t["VT"], missing_prob=hp["missing_prob"],
        )
        with torch.no_grad():
            pv = torch.sigmoid(mil_apply(trained, t["XV"], t["MV"], gated=hp["gated"]))
            pc = torch.sigmoid(mil_apply(trained, t["XC"], t["MC"], gated=hp["gated"]))
        out.append(torch.cat([pv, pc]))
    return torch.stack(out).cpu().numpy()


def _run_parallel_cv_mil(config, folds, masks, scenarios, group_col, calib_dfs,
                         do_calibrate, nested):
    device = get_device()
    params_cfg = config["params"]
    mil_col = config.get("mil_column", "mri_mil")
    K = len(folds)
    missing_prob = float(params_cfg.get("missing_prob", 0.5))
    gated = bool(params_cfg.get("gated", False))
    patience = int(params_cfg.get("early_stopping_patience", 0))
    max_grad_norm = params_cfg.get("max_grad_norm")
    track_best = patience > 0

    # ---- collect per-fold bag sets --------------------------------------
    fold_rows = []
    bag_dims, bag_lens, tr_lens = set(), [], []
    for fi, (train_df, val_df) in enumerate(folds):
        val_masks = get_subset_masks(masks, val_df.index)
        bags_tr = train_df[mil_col].tolist()
        keep_tr = [j for j, b in enumerate(bags_tr) if b is not None]
        bags_va = val_df[mil_col].tolist()
        keep_va = [j for j, b in enumerate(bags_va) if b is not None]

        if do_calibrate and nested:
            calib_df = calib_dfs[fi]
            calib_masks = get_subset_masks(masks, calib_df.index)
            bags_cal = calib_df[mil_col].tolist()
            keep_cal = [j for j, b in enumerate(bags_cal) if b is not None]
            y_cal = calib_df[TARGET_COL].values.astype(np.float32)
            cal_mri = calib_masks.get("mri")
        else:
            bags_cal, keep_cal = bags_va, keep_va
            y_cal = val_df[TARGET_COL].values.astype(np.float32)
            cal_mri = val_masks.get("mri")

        for src, kp in ((bags_tr, keep_tr), (bags_va, keep_va), (bags_cal, keep_cal)):
            for j in kp:
                b = np.asarray(src[j])
                bag_lens.append(b.shape[0])
                bag_dims.add(b.shape[1])
                if src is bags_tr:
                    tr_lens.append(b.shape[0])

        fold_rows.append({
            "bags_tr": [np.asarray(bags_tr[j], np.float32) for j in keep_tr],
            "y_tr": train_df[TARGET_COL].values.astype(np.float32)[keep_tr],
            "bags_va": bags_va, "keep_va": keep_va,
            "y_va": val_df[TARGET_COL].values.astype(np.float32),
            "val_masks": val_masks, "val_df": val_df,
            "bags_cal": bags_cal, "keep_cal": keep_cal, "y_cal": y_cal,
            "cal_mri": cal_mri,
        })

    if len(bag_dims) != 1:
        raise ValueError(f"inconsistent MIL bag feature dims: {bag_dims}")
    input_dim = bag_dims.pop()
    if "max_len" in params_cfg:
        # a configured max_len that would truncate TRAINING bags raises;
        # val/cal bags longer than it just widen the shared pad
        max_len = int(params_cfg["max_len"])
        if tr_lens and max_len < max(tr_lens):
            raise ValueError(
                f"config max_len={max_len} would truncate training bags "
                f"(longest bag has {max(tr_lens)} instances)"
            )
        max_len = max(max_len, ((max(bag_lens) + 7) // 8) * 8)
    else:
        max_len = ((max(bag_lens) + 7) // 8) * 8

    n_tr = [len(r["bags_tr"]) for r in fold_rows]
    n_tr_max = max(n_tr)
    nv_w = max(max(len(r["keep_va"]) for r in fold_rows), 1)
    nc_w = max(max(len(r["keep_cal"]) for r in fold_rows), 1) if do_calibrate else 1
    # one batch size for all folds: the smallest fold's min(batch_size, n)
    # (floor of 1: a fold with no kept training bag trains as a no-op)
    batch_size = max(1, min(int(params_cfg.get("batch_size", 16)), min(n_tr)))

    X = np.zeros((K, n_tr_max, max_len, input_dim), np.float32)
    BM = np.zeros((K, n_tr_max, max_len), np.float32)
    Y = np.zeros((K, n_tr_max), np.float32)
    WR = np.zeros((K, n_tr_max), np.float32)
    XV = np.zeros((K, nv_w, max_len, input_dim), np.float32)
    MV = np.zeros((K, nv_w, max_len), np.float32)
    XC = np.zeros((K, nc_w, max_len, input_dim), np.float32)
    MC = np.zeros((K, nc_w, max_len), np.float32)
    pos_w = np.ones((K,), np.float32)

    for i, r in enumerate(fold_rows):
        xt, mt = _pad_kept_bags(r["bags_tr"], list(range(n_tr[i])), max_len, input_dim, n_tr_max)
        X[i], BM[i] = xt, mt
        Y[i, : n_tr[i]] = r["y_tr"]
        WR[i, : n_tr[i]] = 1.0
        XV[i], MV[i] = _pad_kept_bags(r["bags_va"], r["keep_va"], max_len, input_dim, nv_w)
        if do_calibrate:
            XC[i], MC[i] = _pad_kept_bags(r["bags_cal"], r["keep_cal"], max_len, input_dim, nc_w)
        if params_cfg.get("class_weight") == "balanced":
            pos = float((r["y_tr"] == 1).sum())
            neg = float((r["y_tr"] == 0).sum())
            pos_w[i] = neg / pos if pos > 0 else 1.0
        elif params_cfg.get("pos_weight") is not None:
            pos_w[i] = float(params_cfg["pos_weight"])

    # early-stopping tracking set per fold: the calibration split when
    # nested, else the val fold. ALL its rows enter the per-epoch AUC; a
    # missing bag scores the constant missing_prob (VT flags those rows).
    if track_best and nested:
        frames = [(r["bags_cal"], r["y_cal"]) for r in fold_rows]
    else:
        frames = [(r["bags_va"], r["y_va"]) for r in fold_rows]
    if track_best:
        nt_w = max(max(len(yf) for _, yf in frames), 1)
        Xt = np.zeros((K, nt_w, max_len, input_dim), np.float32)
        # all-ones mask on missing/padding rows: finite logits through the
        # masked softmax (missing rows are overridden via VT; padding rows
        # carry Wt == 0 and are excluded from the weighted AUC)
        Mt = np.ones((K, nt_w, max_len), np.float32)
        Yt = np.zeros((K, nt_w), np.float32)
        Wt = np.zeros((K, nt_w), np.float32)
        VT = np.zeros((K, nt_w), np.float32)
        for i, (bags_t, y_t) in enumerate(frames):
            nt = len(y_t)
            keep = [j for j, b in enumerate(bags_t) if b is not None]
            if keep:
                xk, mk = _pad_kept_bags(bags_t, keep, max_len, input_dim, len(keep))
                Xt[i, keep], Mt[i, keep] = xk, mk
            for j in range(nt):
                VT[i, j] = 0.0 if bags_t[j] is not None else 1.0
            Yt[i, :nt] = y_t
            Wt[i, :nt] = 1.0
    else:
        # unused by the trainer when track_best is False
        Xt = np.zeros((K, 1, max_len, input_dim), np.float32)
        Mt = np.ones((K, 1, max_len), np.float32)
        Yt = np.zeros((K, 1), np.float32)
        Wt = np.zeros((K, 1), np.float32)
        VT = np.zeros((K, 1), np.float32)

    # interleaved (init, train) draws per fold = the sequential loop's
    # consumption order of the global chain
    gens = [(fresh_generator(), fresh_generator(device)) for _ in range(K)]

    hp = {
        "input_dim": input_dim,
        "hidden_dim": int(params_cfg.get("hidden_dim", 128)),
        "attn_dim": int(params_cfg.get("attn_dim", 64)),
        "gated": gated,
        "lr": float(params_cfg.get("lr", 1e-3)),
        "max_grad_norm": float(np.float32(max_grad_norm or 1.0)),
        "epochs": int(params_cfg.get("epochs", 30)),
        "batch_size": batch_size,
        "dropout": float(params_cfg.get("dropout", 0.3)),
        "weight_decay": float(params_cfg.get("weight_decay", 0.0)),
        "use_clip": bool(max_grad_norm),
        "track_best": track_best,
        "patience": patience if track_best else 0,
        "missing_prob": missing_prob,
    }
    arrays = {"X": X, "BM": BM, "Y": Y, "WR": WR, "Xt": Xt, "Mt": Mt, "Yt": Yt, "Wt": Wt,
              "VT": VT, "XV": XV, "MV": MV, "XC": XC, "MC": MC, "pos_w": pos_w}
    buf = _train_predict_folds(arrays, gens, hp, device)
    kept_val_probs = buf[:, :nv_w]
    kept_cal_probs = buf[:, nv_w:]

    probs, yv, wv, _ = _assemble_mil_scenario_probs(
        fold_rows, kept_val_probs, scenarios, missing_prob
    )

    if do_calibrate:
        # host isotonic, as the JAX package's MIL branch: calibration-set
        # probs assembled the way predict_proba would (missing bags / masked
        # mri -> missing_prob constants)
        from pd_fusion_torch.models.calibrate import IsotonicRegression

        for i, r in enumerate(fold_rows):
            nc = len(r["y_cal"])
            vec = np.full(nc, missing_prob, np.float32)
            for slot, row in enumerate(r["keep_cal"]):
                if r["cal_mri"] is None or r["cal_mri"][row] != 0:
                    vec[row] = kept_cal_probs[i, slot]
            iso = IsotonicRegression()
            iso.fit(vec, r["y_cal"])
            probs[i] = iso.transform(probs[i].ravel()).reshape(probs[i].shape)

    packed = _metrics_from_probs_packed(
        torch.as_tensor(probs, device=device), torch.as_tensor(yv, device=device),
        torch.as_tensor(wv, device=device),
    ).cpu().numpy()
    return _fold_results(packed, scenarios, group_col, [r["val_df"] for r in fold_rows],
                         [r["y_va"] for r in fold_rows])
