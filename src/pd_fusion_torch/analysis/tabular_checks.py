"""Checks of the PPMI suites' device programs, shared by ``chip_smoke.py``
and the ``cuda``-marked tests (``tests/test_torch_port_cuda.py``), and the
seeded synthetic study data both drive the suites with.

Card against CPU, on the same inputs:

- the balanced logistic fit (``nn/logreg.py``): both solve to the optimum
  in float64, so the coefficients agree to ``LOGREG_RTOL`` (relative to
  the largest);
- the batched AUC screen (``ops/metrics.py::roc_auc``): its sums are
  of 0/1 and halves, exact in float32 at these sizes, so the AUCs agree to
  ``AUC_ATOL``;
- the permutation probes (``analysis/tabular.py::permutation_screen``):
  with balanced weights the bias's gradient at the zero start is 0 in
  exact arithmetic, so its first Adam step (``lr * g / (|g| + eps)``) is
  set by float32 rounding, which differs between devices (and between the
  port and the JAX package on one device); the weights then differ by
  about 1e-3 and a held-out pair may order the other way. The AUCs agree
  to ``PERM_AUC_ATOL``;
- the GBDT arm's fold-batched fit (``nn/gbdt.py::fit_gbdt_stack``) against
  each model's own ``fit`` on the same device: bit for bit where the
  device's sums come out in the same order, else the same splits at every
  round or, where a near-tie forks, both ensembles optimal under the
  float32 split audit (``nn/gbdt_checks.py``).

``TabularPrep`` is host numpy: it is held against the sweep's
``ColumnTransformer`` copy (``analysis/column_transformer.py``), whose
numeric block computes the same impute, indicators and z-score, to
``PREP_ATOL`` (numpy's ``std`` and scikit-learn's variance sum in two
orders).
"""
import contextlib
import os
from pathlib import Path

import numpy as np
import pandas as pd

LOGREG_RTOL = 1e-8
AUC_ATOL = 1e-6
PERM_AUC_ATOL = 5e-3
PREP_ATOL = 1e-12
# the suites' widths at the synthetic study data's size: a train part of
# 1,050 subjects and the widest ablation's 200 columns; the screen over
# every numeric column of 1,500 subjects
LOGREG_SHAPE = (1050, 200)
AUC_SHAPE = (200, 1500)
PERM_SHAPE = (1500, 200)
GBDT_STACK = dict(K=5, n=1050, f=160, rounds=40)


@contextlib.contextmanager
def on_device(device):
    """The port's functions on ``device`` (``PD_FUSION_TORCH_DEVICE``)."""
    before = os.environ.get("PD_FUSION_TORCH_DEVICE")
    os.environ["PD_FUSION_TORCH_DEVICE"] = str(device)
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("PD_FUSION_TORCH_DEVICE")
        else:
            os.environ["PD_FUSION_TORCH_DEVICE"] = before


def tabular_data(n, d, seed=0, miss=0.1):
    """A standardised-ish design with correlated columns, missing values
    and a binary label with signal in a few columns (about 2:1 positive)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d)
    X[:, 1:] += 0.3 * X[:, :1]
    logits = 1.2 * X[:, 0] - 0.8 * X[:, 1] + 0.5 * X[:, 2] + 0.7
    y = (rng.rand(n) < 1.0 / (1.0 + np.exp(-logits))).astype(np.int64)
    X[rng.rand(n, d) < miss] = np.nan
    return X, y


def check_logreg(device="cuda", shape=LOGREG_SHAPE, seed=0) -> float:
    """A balanced fit on ``device`` and on the CPU; -> the coefficients'
    largest difference relative to the largest coefficient."""
    from pd_fusion_torch.nn.logreg import BalancedLogisticRegression

    X, y = tabular_data(*shape, seed=seed, miss=0.0)
    X = (X - X.mean(0)) / X.std(0)
    fits = []
    for dev in (device, "cpu"):
        with on_device(dev):
            fits.append(BalancedLogisticRegression(max_iter=2000).fit(X, y))
    a, b = (np.r_[m.coef_[0], m.intercept_] for m in fits)
    err = float(np.abs(a - b).max() / np.abs(b).max())
    if err > LOGREG_RTOL:
        raise AssertionError(f"logistic fit on {device} vs CPU: {err:.3e} > {LOGREG_RTOL}")
    return err


def check_auc_screen(device="cuda", shape=AUC_SHAPE, seed=1) -> float:
    """``roc_auc`` over [F, N] columns with ties, ``device`` vs CPU."""
    import torch

    from pd_fusion_torch.ops.metrics import roc_auc

    F, N = shape
    rng = np.random.RandomState(seed)
    cols = rng.randn(F, N).astype(np.float32)
    cols[: F // 4] = np.round(cols[: F // 4] * 2)  # tied scores
    y = (rng.rand(N) < 0.66).astype(np.float32)
    out = [roc_auc(torch.as_tensor(y, device=d), torch.as_tensor(cols, device=d)).cpu()
           .numpy() for d in (device, "cpu")]
    err = float(np.abs(out[0] - out[1]).max())
    if err > AUC_ATOL:
        raise AssertionError(f"AUC screen on {device} vs CPU: {err:.3e} > {AUC_ATOL}")
    return err


def check_permutation_screen(device="cuda", shape=PERM_SHAPE, seed=2) -> float:
    """``permutation_screen`` (5 repeats, 80 epochs) on ``device`` and on
    the CPU; -> the AUCs' largest difference."""
    from pd_fusion_torch.analysis.tabular import permutation_screen

    X, y = tabular_data(*shape, seed=seed)
    df = pd.DataFrame(X, columns=[f"f{j}" for j in range(X.shape[1])]).assign(label=y)
    cols = [c for c in df.columns if c != "label"]
    aucs = []
    for dev in (device, "cpu"):
        with on_device(dev):
            aucs.append(np.array([r["roc_auc"] for r in permutation_screen(df, cols)]))
    err = float(np.abs(aucs[0] - aucs[1]).max())
    if err > PERM_AUC_ATOL:
        raise AssertionError(f"permutation screen on {device} vs CPU: {err:.3e} > {PERM_AUC_ATOL}")
    return err


def check_tabular_prep(shape=(400, 30), seed=3) -> float:
    """``TabularPrep`` against the sweep transformer's numeric block (median
    impute, indicators for train-NaN columns, z-score); -> largest
    difference on the train and a held-out part."""
    from pd_fusion_torch.analysis.column_transformer import SuiteColumnTransformer
    from pd_fusion_torch.analysis.tabular import TabularPrep

    X, y = tabular_data(*shape, seed=seed, miss=0.15)
    df = pd.DataFrame(X, columns=[f"f{j}" for j in range(X.shape[1])])
    tr, te = df.iloc[: shape[0] * 3 // 4], df.iloc[shape[0] * 3 // 4:]
    cols = list(df.columns)
    prep = TabularPrep(scale=True, add_indicators=True)
    ref = SuiteColumnTransformer(True, cols, [])
    err = max(float(np.abs(prep.fit_transform(tr, cols) - ref.fit_transform(tr)).max()),
              float(np.abs(prep.transform(te) - ref.transform(te)).max()))
    if err > PREP_ATOL:
        raise AssertionError(f"TabularPrep vs the sweep transformer: {err:.3e} > {PREP_ATOL}")
    return err


def check_gbdt_stack(device="cuda", K=5, n=1050, f=160, rounds=40, seed=4) -> dict:
    """``K`` device GBDTs with the suites' settings (``rounds`` trees),
    each on its own data (row counts and widths differ by one or two, as
    the suites' folds do), fitted as one stack and one by one on
    ``device``. -> {"bitwise": ..., "first_fork": round or None}."""
    from pd_fusion_torch.analysis.tabular import SUITE_GBDT
    from pd_fusion_torch.nn import gbdt_checks
    from pd_fusion_torch.nn.gbdt import DeviceHistGBDT, fit_gbdt_stack

    hp = dict(SUITE_GBDT, n_estimators=rounds)
    Xs, ys = [], []
    for k in range(K):
        X, y = tabular_data(n - k % 2, f + k % 3, seed=seed * 10 + k)
        Xs.append(X.astype(np.float32))
        ys.append(y)
    with on_device(device):
        stacked = fit_gbdt_stack([DeviceHistGBDT(**hp) for _ in range(K)], Xs, ys)
        single = [DeviceHistGBDT(**hp).fit(X, y) for X, y in zip(Xs, ys)]
    bitwise, first_fork = True, None
    for m, s, X, y in zip(stacked, single, Xs, ys):
        bitwise = bitwise and gbdt_checks.bitwise_equal(m.trees_, s.trees_)
        fork = next((r for r in range(rounds) if not gbdt_checks.same_structure(
            {k: v[r] for k, v in m.trees_.items()}, {k: v[r] for k, v in s.trees_.items()})),
            None)
        if fork is None:
            if not np.allclose(m.trees_["leaf"], s.trees_["leaf"], rtol=1e-5, atol=1e-7):
                raise AssertionError("stacked GBDT leaves differ from the model's own fit")
            continue
        first_fork = fork if first_fork is None else min(first_fork, fork)
        _, bins, yf, w, base = m._fit_inputs(X, y)
        hpt = m.hparams()
        for trees in (m.trees_, s.trees_):
            gbdt_checks.audit_trees(bins, yf, w, trees, rounds, hpt["depth"], hpt["lr"],
                                    hpt["lam"], hpt["min_child_weight"],
                                    hpt["min_child_samples"], float(base),
                                    **gbdt_checks.F32_TOLS)
    return {"bitwise": bitwise, "first_fork": first_fork}


# ---------------------------------------------------------------------------
# seeded synthetic study data shaped like PPMI's tables
# ---------------------------------------------------------------------------

UPDRS3_ITEMS = (
    "NP3SPCH NP3FACXP NP3RIGN NP3RIGRU NP3RIGLU NP3RIGRL NP3RIGLL NP3FTAPR NP3FTAPL "
    "NP3HMOVR NP3HMOVL NP3PRSPR NP3PRSPL NP3TTAPR NP3TTAPL NP3LGAGR NP3LGAGL NP3RISNG "
    "NP3GAIT NP3FRZGT NP3PSTBL NP3POSTR NP3BRADY NP3PTRMR NP3PTRML NP3KTRMR NP3KTRML "
    "NP3RTARU NP3RTALU NP3RTARL NP3RTALL NP3RTALJ NP3RTCON").split()
ASEG = [f"{side}-{part}" for side in ("Left", "Right") for part in (
    "Lateral-Ventricle", "Inf-Lat-Vent", "Cerebellum-White-Matter", "Cerebellum-Cortex",
    "Thalamus", "Caudate", "Putamen", "Pallidum", "Hippocampus", "Amygdala", "Accumbens-area",
    "VentralDC", "choroid-plexus", "vessel", "Cerebral-White-Matter", "Cerebral-Cortex")] + [
    "3rd-Ventricle", "4th-Ventricle", "Brain-Stem", "CSF", "CC_Posterior", "CC_Mid_Posterior",
    "CC_Central", "CC_Mid_Anterior", "CC_Anterior", "EstimatedTotalIntraCranialVol"]
DK_REGIONS = (
    "bankssts caudalanteriorcingulate caudalmiddlefrontal cuneus entorhinal fusiform "
    "inferiorparietal inferiortemporal isthmuscingulate lateraloccipital lateralorbitofrontal "
    "lingual medialorbitofrontal middletemporal parahippocampal paracentral parsopercularis "
    "parsorbitalis parstriangularis pericalcarine postcentral posteriorcingulate precentral "
    "precuneus rostralanteriorcingulate rostralmiddlefrontal superiorfrontal superiorparietal "
    "superiortemporal supramarginal frontalpole temporalpole transversetemporal insula").split()
SBR = ("DATSCAN_CAUDATE_R", "DATSCAN_CAUDATE_L", "DATSCAN_PUTAMEN_R", "DATSCAN_PUTAMEN_L",
       "DATSCAN_PUTAMEN_R_ANT", "DATSCAN_PUTAMEN_L_ANT")
COHORTS = ("Parkinson's Disease", "Healthy Control", "SWEDD", "Prodromal")


def write_synthetic_study_data(study_dir: Path, n_subjects: int = 1500, seed: int = 0,
                               n_excluded: int = 200) -> dict:
    """One CSV per table pattern of ``configs/ppmi_studydata.yaml``, shaped
    like PPMI's exports: ``n_subjects`` PD and HC subjects at about PPMI's
    de novo 2:1, plus ``n_excluded`` SWEDD and prodromal subjects the label
    map drops. Clinical visits SC, BL and V04 (a tenth of the subjects
    without BL, so SC is their baseline); MDS-UPDRS III's 33 items, total
    and H&Y; MoCA; the GDS-15, STAI-40, Epworth-8 and UPSIT items and
    totals; 42 aseg volumes (3% of the cells missing) and 68 cortical
    thicknesses (a fifth of the subjects without MRI), 6 striatal SBRs and
    the visual read (a tenth without DaTscan), all at the baseline visit. Label signal lies in the motor items, the
    SBRs, UPSIT and a few volumes. -> {"n_pd", "n_hc", "n_excluded"}."""
    rng = np.random.RandomState(seed)
    study_dir = Path(study_dir)
    study_dir.mkdir(parents=True, exist_ok=True)
    n_all = n_subjects + n_excluded
    patno = 3000 + np.arange(n_all)
    pd_label = np.r_[rng.rand(n_subjects) < 2.0 / 3.0, np.zeros(n_excluded, bool)]
    cohort = np.where(pd_label, COHORTS[0], COHORTS[1]).astype(object)
    cohort[n_subjects:] = rng.choice(COHORTS[2:], n_excluded)
    sev = np.where(pd_label, rng.gamma(4.0, 0.5, n_all), rng.gamma(1.0, 0.15, n_all))
    pd.DataFrame({"PATNO": patno, "COHORT": cohort,
                  "ENROLL_AGE": np.round(rng.normal(62, 9.5, n_all), 1)}).to_csv(
        study_dir / "Participant_Status.csv", index=False)
    pd.DataFrame({"PATNO": patno, "COHORT_DESCRIPTION": cohort}).to_csv(
        study_dir / "Subject_Cohort_History.csv", index=False)
    pd.DataFrame({"PATNO": patno, "SEX": rng.randint(0, 2, n_all),
                  "EDUCYRS": rng.randint(8, 21, n_all),
                  "HANDED": rng.choice(["Right", "Left", "Mixed"], n_all, p=[0.86, 0.1, 0.04]),
                  "HISPLAT": rng.randint(0, 2, n_all)}).to_csv(
        study_dir / "Demographics.csv", index=False)

    no_bl = rng.rand(n_all) < 0.1
    visits = []
    for event, month in (("SC", -1), ("BL", 0), ("V04", 12)):
        keep = ~no_bl if event == "BL" else np.ones(n_all, bool)
        visits.append((event, month, keep))

    def visit_table(name, columns):
        rows = []
        for event, month, keep in visits:
            drift = 1.0 + 0.08 * max(month, 0) / 12.0
            frame = {"PATNO": patno[keep], "EVENT_ID": event,
                     "INFODT": f"2016-{3 + max(month, 0) // 12:02d}-01"}
            for col, fn in columns.items():
                frame[col] = fn(keep, drift)
            rows.append(pd.DataFrame(frame))
        pd.concat(rows, ignore_index=True).to_csv(study_dir / name, index=False)

    items = {it: (lambda k, d, it=it: np.clip(np.round(sev[k] * d * rng.uniform(0.2, 0.9)
                                                        + rng.normal(0, 0.4, k.sum())), 0, 4))
             for it in UPDRS3_ITEMS}
    visit_table("MDS_UPDRS_Part_III.csv", {
        **items, "NP3TOT": lambda k, d: np.round(sev[k] * d * 14 + rng.normal(0, 3, k.sum())),
        "NHY": lambda k, d: np.clip(np.round(sev[k] * d * 0.9), 0, 5)})
    visit_table("Age_at_visit.csv", {"AGE_AT_VISIT": lambda k, d: np.round(
        rng.normal(62, 9.5, k.sum()) + 10 * (d - 1), 1)})
    visit_table("Montreal_Cognitive_Assessment__MoCA_.csv", {
        "MCATOT": lambda k, d: np.clip(np.round(27 - 0.6 * sev[k] + rng.normal(0, 2, k.sum())),
                                       10, 30),
        "MCAVFNUM": lambda k, d: np.round(rng.normal(12, 4, k.sum()))})
    visit_table("Geriatric_Depression_Scale__GDS_.csv", {
        **{f"GDS{i:02d}": (lambda k, d: (rng.rand(k.sum()) < 0.15).astype(float))
           for i in range(1, 16)},
        "GDSTOT": lambda k, d: np.round(rng.gamma(2, 1.2, k.sum()) + 0.3 * sev[k])})
    visit_table("State-Trait_Anxiety_Inventory__STAI_.csv", {
        f"STAIAD{i}": (lambda k, d: rng.randint(1, 5, k.sum()).astype(float))
        for i in range(1, 41)})
    visit_table("Epworth_Sleepiness_Scale.csv", {
        **{f"ESS{i}": (lambda k, d: rng.randint(0, 4, k.sum()).astype(float)) for i in range(1, 9)},
        "ESS_TOTAL": lambda k, d: np.round(rng.gamma(3, 2, k.sum()) + 0.5 * sev[k])})
    visit_table("University_of_Pennsylvania_Smell_Identification_Test__UPSIT_.csv", {
        **{f"UPSIT_PRCNTGE{i}": (lambda k, d: np.round(rng.uniform(30, 100, k.sum())))
           for i in range(1, 5)},
        "UPSIT_TOTAL": lambda k, d: np.clip(np.round(
            34 - 4.5 * np.minimum(sev[k], 3) + rng.normal(0, 3, k.sum())), 5, 40)})

    # imaging at the baseline visit (SC where a subject has no BL)
    event = np.where(no_bl, "SC", "BL")
    mri = rng.rand(n_all) > 0.2
    base = {"PATNO": patno[mri], "EVENT_ID": event[mri]}
    aseg = {c: np.round(rng.lognormal(np.log(3000.0 + 400 * j), 0.12, mri.sum())
                        * (1 - 0.02 * (sev[mri] if "Putamen" in c else 0)), 1)
            for j, c in enumerate(ASEG)}
    for c in aseg:
        aseg[c][rng.rand(mri.sum()) < 0.03] = np.nan
    pd.DataFrame({**base, **aseg}).to_csv(study_dir / "FS7_aseg_volumes.csv", index=False)
    thick = {f"{h}_{r}_thickness": np.round(rng.normal(2.5, 0.15, mri.sum()), 3)
             for h in ("lh", "rh") for r in DK_REGIONS}
    pd.DataFrame({**base, **thick}).to_csv(study_dir / "FS7_Cortical_Thickness.csv", index=False)

    dat = rng.rand(n_all) > 0.1
    loss = np.minimum(sev[dat], 3.0)
    sbr = {c: np.round(rng.normal(2.6 if "CAUDATE" in c else 2.1, 0.35, dat.sum())
                       - (0.25 if "CAUDATE" in c else 0.45) * loss, 3) for c in SBR}
    pd.DataFrame({"PATNO": patno[dat], "EVENT_ID": event[dat], **sbr}).to_csv(
        study_dir / "DaTScan_SBR_Analysis.csv", index=False)
    read = np.where(sbr["DATSCAN_PUTAMEN_L"] < 1.4, "Abnormal", "Normal").astype(object)
    read[rng.rand(dat.sum()) < 0.05] = np.nan
    pd.DataFrame({"PATNO": patno[dat], "EVENT_ID": event[dat], "DATSCAN_VISINTRP": read}).to_csv(
        study_dir / "DaTSCAN_Visual_Read.csv", index=False)
    return {"n_pd": int(pd_label.sum()), "n_hc": int(n_subjects - pd_label.sum()),
            "n_excluded": n_excluded}


def study_config(study_dir: Path, processed_dir: Path, config_path: Path) -> dict:
    """``configs/ppmi_studydata.yaml`` with its data directories pointed at
    ``study_dir`` and ``processed_dir``; every other setting unchanged."""
    import yaml

    cfg = yaml.safe_load(Path(config_path).read_text())
    cfg.update(raw_ppmi_dir=str(Path(study_dir).parent), study_data_dir=str(study_dir),
               processed_ppmi_dir=str(processed_dir))
    return cfg
