"""PPMI "study data" ETL (own copy of ``pd_fusion/data/ppmi_studydata.py``):
raw per-table CSV exports -> model-ready subject-baseline / visit-level
datasets with a feature schema and multi-seed splits.

Fuzzy column detection for subject/visit/month/date, zip extraction,
glob-pattern table resolution, ``table__column`` feature prefixing,
PD-vs-HC label inference with value maps and exclusion keys, visit-level
outer merge, baseline row selection by visit priority (BL > SC > V01),
feature-schema JSON with per-column missing rates, and stratified
train/val/test splits per seed. Every artifact equals the JAX package's.

The splits are scikit-learn's ``train_test_split`` (a float train size,
then an integer one; unstratified where a class has fewer than two
members), run as the numpy copy in ``data/splits.py``: the card's
machine has no scikit-learn, and the copy draws from
``np.random.RandomState(seed)`` in scikit-learn's order, so the subject
lists are the JAX package's.

Host code only (pandas); nothing here runs on the card.
"""
import json
import logging
import re
import zipfile
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd

from pd_fusion_torch.data.splits import train_test_split_positions

KEY_COLS = ("subject_id", "visit_id", "visit_month", "date")

# Normalized-name candidates, in priority order (config candidates are
# consulted first; see _pick_column).
SUBJECT_CANDIDATES = (
    "patno", "subjectid", "subject", "participantid", "rid", "id",
)
VISIT_CANDIDATES = (
    "eventid", "visitid", "visit", "visitnum", "event", "timepoint",
)
MONTH_CANDIDATES = (
    "visitmonth", "month", "months", "visitmnth",
    "monthssincebl", "monthssincebaseline",
)
DATE_CANDIDATES = ("infodt", "examdate", "exam_date", "visitdate", "date")

DIAGNOSIS_CANDIDATES = (
    "diagnosis", "cohort", "cohortdescription", "enrollcat",
    "currentdiagnosis", "primdiag", "dx",
)

POSITIVE_TOKENS = ("pd", "parkinson", "parkinson's disease")
NEGATIVE_TOKENS = ("hc", "healthy", "control")
EXCLUDE_TOKENS = ("swedd", "prodromal", "genetic", "other", "unknown")


def _slug(name: str) -> str:
    """Case/punctuation-insensitive column key ('EVENT_ID' == 'event id')."""
    return re.sub(r"[^a-z0-9]", "", str(name).lower())


def _pick_column(columns: Iterable[str], preferred: Sequence[str], defaults: Sequence[str]) -> Optional[str]:
    by_slug = {}
    for col in columns:
        by_slug.setdefault(_slug(col), col)
    for cand in list(preferred) + list(defaults):
        hit = by_slug.get(_slug(cand))
        if hit is not None:
            return hit
    return None


def _unzip_all(raw_dir: Path, logger: logging.Logger) -> None:
    """Expand any *.zip under the study dir into raw_dir/extracted (the
    reference does the same before globbing tables)."""
    target = raw_dir / "extracted"
    for zpath in raw_dir.glob("**/*.zip"):
        target.mkdir(parents=True, exist_ok=True)
        try:
            with zipfile.ZipFile(zpath) as zf:
                zf.extractall(target)
            logger.info("Extracted %s -> %s", zpath.name, target)
        except zipfile.BadZipFile:
            logger.warning("Not a zip archive, skipping: %s", zpath)


def _glob_tables(study_dir: Path, patterns: Sequence[str]) -> List[Path]:
    found: List[Path] = []
    seen = set()
    for pat in patterns:
        for hit in list(study_dir.glob(pat)) + list(study_dir.glob(f"**/{pat}")):
            if hit.is_file() and hit.suffix.lower() == ".csv" and hit not in seen:
                seen.add(hit)
                found.append(hit)
    return found


def _to_months(series: pd.Series) -> pd.Series:
    if pd.api.types.is_numeric_dtype(series):
        return series
    return pd.to_numeric(series.astype(str).str.extract(r"(\d+)", expand=False), errors="coerce")


def canonicalize(df: pd.DataFrame, name: str, cfg: Dict) -> Tuple[pd.DataFrame, bool]:
    """Rename the fuzzy-detected key columns to the canonical KEY_COLS and
    collapse duplicate (subject, visit) rows (first non-null per column).
    Returns (frame, has_visit)."""
    hints = cfg.get("column_candidates", {})
    subj = _pick_column(df.columns, hints.get("subject_id", ()), SUBJECT_CANDIDATES)
    if subj is None:
        raise ValueError(f"table '{name}': no subject-id column detected")
    visit = _pick_column(df.columns, hints.get("visit_id", ()), VISIT_CANDIDATES)
    month = _pick_column(df.columns, hints.get("visit_month", ()), MONTH_CANDIDATES)
    date = _pick_column(df.columns, hints.get("date", ()), DATE_CANDIDATES)

    out = df.rename(columns={subj: "subject_id"}).copy()
    out["subject_id"] = out["subject_id"].astype(str)
    if visit is not None:
        out = out.rename(columns={visit: "visit_id"})
        out["visit_id"] = out["visit_id"].astype(str)
    else:
        out["visit_id"] = pd.NA
    out["visit_month"] = _to_months(out[month]) if month is not None else pd.NA
    if month is not None and month != "visit_month":
        out = out.drop(columns=[month])
    if date is not None:
        parsed = pd.to_datetime(out[date], errors="coerce")
        if date != "date":
            out = out.drop(columns=[date])
        out["date"] = parsed
    else:
        out["date"] = pd.NaT

    keys = ["subject_id", "visit_id"] if visit is not None else ["subject_id"]
    out = out.groupby(keys, as_index=False, dropna=False).first()
    ordered = list(KEY_COLS) + [c for c in out.columns if c not in KEY_COLS]
    return out[ordered], visit is not None


def collect_tables(cfg: Dict, logger: logging.Logger):
    """Resolve + read + canonicalize every configured table.

    Yields (name, group, frame, has_visit); feature columns already carry
    the ``table__column`` prefix for non-label groups."""
    study_dir = Path(cfg["study_data_dir"])
    if cfg.get("extract_zips", True):
        _unzip_all(study_dir, logger)

    out = []
    for name, spec in cfg.get("tables", {}).items():
        paths = _glob_tables(study_dir, spec.get("patterns", ()))
        if not paths:
            logger.warning("table '%s': no files matched %s", name, spec.get("patterns"))
            continue
        parts = []
        for p in paths:
            try:
                parts.append(pd.read_csv(p, low_memory=False))
                logger.info("table '%s': read %s", name, p.name)
            except Exception as exc:
                logger.warning("table '%s': unreadable %s (%s)", name, p, exc)
        if not parts:
            continue
        try:
            frame, has_visit = canonicalize(pd.concat(parts, ignore_index=True), name, cfg)
        except ValueError as exc:
            logger.warning("skipping table: %s", exc)
            continue
        group = spec.get("group", "clinical")
        if group != "labels":
            frame = frame.rename(
                columns={c: f"{name}__{c}" for c in frame.columns if c not in KEY_COLS}
            )
        out.append((name, group, frame, has_visit))
    return out


def _classify_value(value, value_map: Dict, pos, neg, excl) -> Optional[int]:
    if value in value_map:
        return int(value_map[value])
    text = str(value).strip().lower()
    if text in value_map:
        return int(value_map[text])
    if any(tok in text for tok in excl):
        return None
    if any(tok in text for tok in pos):
        return 1
    if any(tok in text for tok in neg):
        return 0
    return None


def derive_labels(tables, cfg: Dict, logger: logging.Logger) -> pd.Series:
    """subject_id -> {0,1} from the 'labels'-group tables.

    The diagnosis column's *unique* values are classified once and
    broadcast via map; conflicting per-subject labels resolve to the
    first occurrence (matching the reference) and are counted."""
    lab_cfg = cfg.get("label", {})
    vmap = dict(lab_cfg.get("value_map", {}))
    pos = tuple(lab_cfg.get("positive_values", POSITIVE_TOKENS))
    neg = tuple(lab_cfg.get("negative_values", NEGATIVE_TOKENS))
    excl = tuple(lab_cfg.get("exclude_values", EXCLUDE_TOKENS))
    diag_cands = tuple(lab_cfg.get("diagnosis_column_candidates", DIAGNOSIS_CANDIDATES))

    pieces = []
    excluded = 0
    for name, group, frame, _ in tables:
        if group != "labels":
            continue
        diag = _pick_column(frame.columns, diag_cands, DIAGNOSIS_CANDIDATES)
        if diag is None:
            logger.warning("label table '%s': no diagnosis column", name)
            continue
        raw = frame[["subject_id", diag]].dropna(subset=[diag])
        lut = {v: _classify_value(v, vmap, pos, neg, excl) for v in raw[diag].unique()}
        mapped = raw[diag].map(lut)
        excluded += int(mapped.isna().sum())
        keep = raw.loc[mapped.notna(), ["subject_id"]].assign(label=mapped.dropna().astype(int))
        pieces.append(keep)

    if not pieces:
        return pd.Series(dtype=int, name="label")
    allrows = pd.concat(pieces, ignore_index=True)
    per_subject = allrows.groupby("subject_id")["label"].nunique()
    conflicts = int((per_subject > 1).sum())
    if conflicts:
        logger.warning("conflicting labels for %d subjects (keeping first)", conflicts)
    if excluded:
        logger.info("excluded %d label rows outside PD/HC", excluded)
    resolved = allrows.drop_duplicates("subject_id", keep="first")
    return resolved.set_index("subject_id")["label"]


def assemble_visits(tables) -> pd.DataFrame:
    """Visit spine (union of observed subject/visit keys) with every
    feature table left-merged on; subject-level tables broadcast across a
    subject's visits."""
    spines = [
        frame[list(KEY_COLS)]
        for _, group, frame, has_visit in tables
        if has_visit
    ]
    if spines:
        spine = (
            pd.concat(spines, ignore_index=True)
            .drop_duplicates(["subject_id", "visit_id"])
            .sort_values(["subject_id", "visit_month", "date"], na_position="last")
            .reset_index(drop=True)
        )
    else:
        subjects = sorted({s for _, _, f, _ in tables for s in f["subject_id"].unique()})
        spine = pd.DataFrame(
            {"subject_id": subjects, "visit_id": "BL", "visit_month": pd.NA, "date": pd.NaT}
        )

    merged = spine
    for name, group, frame, has_visit in tables:
        if group == "labels":
            continue
        feats = [c for c in frame.columns if c not in KEY_COLS]
        if has_visit:
            merged = merged.merge(
                frame[["subject_id", "visit_id"] + feats],
                on=["subject_id", "visit_id"],
                how="left",
            )
        else:
            merged = merged.merge(frame[["subject_id"] + feats], on="subject_id", how="left")
    return merged


def pick_baseline(visit_df: pd.DataFrame, priority: Sequence[str]) -> pd.DataFrame:
    """One row per subject: lowest priority-rank visit, ties broken by
    visit_month then date (a stable sort + drop_duplicates — no
    groupby.apply)."""
    rank_of = {str(v).upper(): i for i, v in enumerate(priority)}
    ranks = visit_df["visit_id"].astype(str).str.upper().map(rank_of)
    ordered = (
        visit_df.assign(_rank=ranks.fillna(len(rank_of)))
        .sort_values(["subject_id", "_rank", "visit_month", "date"], na_position="last")
        .drop_duplicates("subject_id", keep="first")
        .drop(columns="_rank")
        .reset_index(drop=True)
    )
    return ordered


def summarize_schema(df: pd.DataFrame, group_features: Dict[str, List[str]]) -> Dict:
    schema = {"groups": {}, "feature_types": {}}
    for group, cols in group_features.items():
        present = [c for c in cols if c in df.columns]
        schema["groups"][group] = {
            "features": present,
            "missing_rate": {c: float(df[c].isna().mean()) for c in present},
        }
        for c in present:
            kind = "numeric" if pd.api.types.is_numeric_dtype(df[c]) else "categorical"
            schema["feature_types"].setdefault(c, kind)
    return schema


def _maybe_stratify(y: np.ndarray) -> Optional[np.ndarray]:
    """The stratified splitter needs >=2 members per class; fall
    back to unstratified on degenerate inputs instead of crashing."""
    _, counts = np.unique(y, return_counts=True)
    return y if len(counts) >= 2 and counts.min() >= 2 else None


def create_splits(labels: pd.Series, seeds: Sequence[int], split_cfg: Dict) -> Dict[int, Dict[str, List[str]]]:
    """Per-seed stratified train/val/test subject-id splits.

    ``labels`` is indexed by subject_id. Sizes come from split_cfg
    (train_size/val_size/test_size, default 0.7/0.15/0.15) and must sum
    to 1."""
    tr = float(split_cfg.get("train_size", 0.7))
    va = float(split_cfg.get("val_size", 0.15))
    te = float(split_cfg.get("test_size", 0.15))
    if not np.isclose(tr + va + te, 1.0):
        raise ValueError(f"split sizes must sum to 1.0 (got {tr}+{va}+{te})")

    subjects = np.asarray(labels.index)
    y = np.asarray(labels.values)
    out: Dict[int, Dict[str, List[str]]] = {}
    for seed in seeds:
        train, rest = train_test_split_positions(
            len(subjects), train_size=tr, stratify=_maybe_stratify(y), seed=seed
        )
        train_ids, rest_ids, y_rest = subjects[train], subjects[rest], y[rest]
        if len(rest_ids) < 2:
            # degenerate cohort: nothing left to divide — put it in test
            val_ids, test_ids = np.array([], dtype=subjects.dtype), rest_ids
        else:
            # integer val count with a floor of 1 so tiny cohorts still
            # produce all three parts (float ratios can round to 0)
            n_val = int(np.clip(round(va / (va + te) * len(rest_ids)), 1, len(rest_ids) - 1))
            val, test = train_test_split_positions(
                len(rest_ids), train_size=n_val, stratify=_maybe_stratify(y_rest), seed=seed
            )
            val_ids, test_ids = rest_ids[val], rest_ids[test]
        out[int(seed)] = {
            "train": [str(s) for s in train_ids],
            "val": [str(s) for s in val_ids],
            "test": [str(s) for s in test_ids],
        }
    return out


def _manifest_md(baseline: pd.DataFrame, visits: pd.DataFrame, groups: Dict[str, List[str]]) -> str:
    lines = [
        "# PPMI Study Data Manifest",
        "",
        f"Subjects (baseline): {baseline['subject_id'].nunique()}",
        f"Visits: {len(visits)}",
        "",
        "## Label counts (baseline)",
        baseline["label"].value_counts().to_string(),
        "",
        "## Feature groups",
    ]
    lines += [f"- {g}: {len(cols)} features" for g, cols in groups.items()]
    lines += ["", "## Missingness (baseline, mean per group)"]
    for g, cols in groups.items():
        present = [c for c in cols if c in baseline.columns]
        if present:
            lines.append(f"- {g}: {baseline[present].isna().mean().mean():.3f}")
    return "\n".join(lines)


def build_ppmi_datasets(config: Dict, logger: logging.Logger) -> Dict[str, Path]:
    """End-to-end build. Writes (and returns paths for) the baseline CSV,
    visit-level CSV, feature-schema JSON, and manifest; split JSONs land
    beside them as ppmi_splits_seed{N}.json."""
    out_dir = Path(config["processed_ppmi_dir"])
    out_dir.mkdir(parents=True, exist_ok=True)

    tables = collect_tables(config, logger)
    labels = derive_labels(tables, config, logger)
    if labels.empty:
        raise ValueError("no PD/HC labels could be inferred from the label tables")

    group_features: Dict[str, List[str]] = {}
    for name, group, frame, _ in tables:
        if group == "labels":
            continue
        group_features.setdefault(group, []).extend(
            c for c in frame.columns if c not in KEY_COLS
        )

    visits = assemble_visits(tables)
    visits = visits.merge(labels.rename("label"), left_on="subject_id", right_index=True, how="left")
    visits = visits[visits["label"].isin([0, 1])].reset_index(drop=True)

    priority = config.get("baseline", {}).get("visit_id_priority", ("BL", "SC", "V01"))
    baseline = pick_baseline(visits, priority)

    paths = {
        "baseline": out_dir / "ppmi_subject_baseline.csv",
        "visit_level": out_dir / "ppmi_visit_level.csv",
        "schema": out_dir / "ppmi_feature_schema.json",
        "manifest": out_dir / "ppmi_manifest.md",
    }
    baseline.to_csv(paths["baseline"], index=False)
    visits.to_csv(paths["visit_level"], index=False)

    schema = summarize_schema(baseline, group_features)
    schema["n_subjects"] = int(baseline["subject_id"].nunique())
    schema["n_visits"] = int(len(visits))
    paths["schema"].write_text(json.dumps(schema, indent=2))

    split_cfg = config.get("splits", {})
    seeds = split_cfg.get("seeds", [42, 43, 44, 45, 46])
    splits = create_splits(baseline.set_index("subject_id")["label"], seeds, split_cfg)
    for seed, split in splits.items():
        (out_dir / f"ppmi_splits_seed{seed}.json").write_text(json.dumps(split, indent=2))

    paths["manifest"].write_text(_manifest_md(baseline, visits, group_features))
    logger.info(
        "built PPMI datasets: %d subjects, %d visits, %d feature groups",
        schema["n_subjects"], schema["n_visits"], len(group_features),
    )
    return paths
