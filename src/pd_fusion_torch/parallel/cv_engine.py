"""K-fold cross-validation engine, MIL family (port of the MIL branch of
``pd_fusion/parallel/cv_engine.py``).

The JAX package trains all folds as one ``vmap``-ed program over a fold
axis. The port keeps that program's inputs exactly: every fold's training
bags are padded to the largest fold with zero row weights (padding rows
join the shuffle and the batch count, as in the JAX program), val /
calibration / tracking sets are padded to shared widths, and each fold
draws its ``(init, train)`` generators in the JAX package's order. It then
loops over the folds in Python; folds as a batch dimension are later
speed work. Every forward through the MIL head pools with the CUDA kernel
K1 on the card.

The tail is the JAX package's: per-scenario probabilities assembled from
the kept-bag probabilities (``missing_prob`` for absent or masked bags),
host isotonic calibration per fold, then all K x S metric sets packed into
one buffer and fetched once.

Other model families raise ``NotImplementedError`` (ROADMAP Queue 1).
"""
import logging
from typing import List

import numpy as np
import torch

from pd_fusion_torch.data.missingness import apply_missingness_scenario
from pd_fusion_torch.data.schema import TARGET_COL
from pd_fusion_torch.data.splits import get_subset_masks
from pd_fusion_torch.ops import metrics as dev_metrics
from pd_fusion_torch.utils.device import get_device
from pd_fusion_torch.utils.seed import fresh_generator

PARALLEL_CV_FAMILIES = {"mil_attention"}

logger = logging.getLogger("pd_fusion")


def supports_parallel_cv(config) -> bool:
    if config.get("parallel_cv", True) is False:
        return False
    return config.get("model_type") in PARALLEL_CV_FAMILIES


def _metrics_from_probs_packed(probs, yv, wv):
    """All K x S metric sets from (host-calibrated) probs [K, S, N],
    packed with the probs into one fetchable buffer."""
    K, S = probs.shape[:2]
    per = [dev_metrics.binary_metrics(yv[i, s], probs[i, s], wv[i, s])
           for i in range(K) for s in range(S)]
    md = {k: torch.stack([m[k] for m in per]).reshape(K, S) for k in dev_metrics.METRIC_NAMES}
    return dev_metrics.pack_metrics_and_probs(md, probs)


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

    if model_type == "mil_attention":
        return _run_parallel_cv_mil(
            config, folds, masks, scenarios, group_col, calib_dfs, do_calibrate, nested,
        )
    raise NotImplementedError(
        f"parallel CV for model_type '{model_type}' is not ported to pd_fusion_torch yet "
        "(ROADMAP Queue 1 items 6-8, 12)"
    )


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

    probs, yv, wv, nv_max = _assemble_mil_scenario_probs(
        fold_rows, kept_val_probs, scenarios, missing_prob
    )

    if do_calibrate:
        # calibration-set probs assembled the same way predict_proba would
        # (missing bags / masked mri -> missing_prob constants)
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
    S = len(scenarios)
    md, probs_out = dev_metrics.unpack_metrics_and_probs(packed, (K, S), (K, S, nv_max))

    metrics_all, fold_preds = [], []
    full_obs_idx = next(
        (i for i, s in enumerate(scenarios) if s["name"] == "full_observation"), 0
    )
    for i, r in enumerate(fold_rows):
        nv = len(r["y_va"])
        res = {}
        for si, scenario in enumerate(scenarios):
            m = {k: float(md[k][i, si]) for k in md}
            if group_col and group_col in r["val_df"].columns:
                from pd_fusion_torch.evaluation.evaluate import _subject_metrics

                subj = _subject_metrics(
                    r["val_df"], group_col, r["y_va"].astype(int), probs_out[i, si, :nv]
                )
                for kk, vv in subj.items():
                    m[f"subject_{kk}"] = vv
            res[scenario["name"]] = m
        metrics_all.append(res)
        fold_preds.append((r["y_va"], probs_out[i, full_obs_idx, :nv]))
    return metrics_all, fold_preds
