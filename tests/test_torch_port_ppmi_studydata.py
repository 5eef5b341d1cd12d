"""The port's PPMI study-data ETL (``pd_fusion_torch/data/ppmi_studydata.py``)
against the JAX package's, on the same files: the builder's baseline and
visit-level CSVs, schema JSON, manifest and split JSONs must be equal byte
for byte (``tests/test_ppmi_studydata.py``'s fixture, with and without the
inverted label map, and the synthetic study data ``chip_smoke.py`` runs at
a small size); ``create_splits`` (scikit-learn's ``train_test_split``,
stratified or not, float then integer sizes, as numpy) must give the JAX
package's subject lists, or raise where it raises, on stratified,
one-class, singleton-class and imbalanced cohorts at several sizes and
seeds; and the build script runs as a module."""
import logging
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from pd_fusion.data import ppmi_studydata as J
from pd_fusion_torch.analysis.tabular_checks import study_config, write_synthetic_study_data
from pd_fusion_torch.data import ppmi_studydata as T
from pd_fusion_torch.data.splits import train_test_split_positions
from pd_fusion_torch.paths import ROOT_DIR
from test_ppmi_studydata import _config, study_dir  # noqa: F401  (the JAX tests' fixture)

LOG = logging.getLogger("test")


def _build_both(cfg, tmp_path):
    out = {}
    for name, mod in (("jax", J), ("port", T)):
        cfg_k = dict(cfg, processed_ppmi_dir=str(tmp_path / name))
        paths = mod.build_ppmi_datasets(cfg_k, LOG)
        out[name] = {p.name: p.read_bytes() for p in (tmp_path / name).iterdir()}
        assert set(paths) == {"baseline", "visit_level", "schema", "manifest"}
    return out


@pytest.mark.parametrize("value_map", [None, {"pd": 0, "hc": 1}], ids=["default", "inverted"])
def test_builder_artifacts_equal_the_jax_package(study_dir, tmp_path, value_map):  # noqa: F811
    raw, _ = study_dir
    cfg = _config(raw, tmp_path / "unused")
    if value_map:
        cfg["label"] = {"value_map": value_map}
    out = _build_both(cfg, tmp_path)
    assert sorted(out["port"]) == sorted(out["jax"]) == sorted(
        ["ppmi_subject_baseline.csv", "ppmi_visit_level.csv", "ppmi_feature_schema.json",
         "ppmi_manifest.md", "ppmi_splits_seed42.json"])
    assert out["port"] == out["jax"]


def test_builder_on_the_synthetic_study_data_equals_the_jax_package(tmp_path):
    """The config's thirteen tables (labels excluded by the value map,
    SC/BL/V04 visits, missing imaging), 120 subjects, the config's five
    seeds."""
    write_synthetic_study_data(tmp_path / "study", n_subjects=120, n_excluded=20)
    cfg = study_config(tmp_path / "study", tmp_path / "unused",
                       ROOT_DIR / "configs" / "ppmi_studydata.yaml")
    out = _build_both(cfg, tmp_path)
    assert out["port"] == out["jax"]
    base = pd.read_csv(tmp_path / "port" / "ppmi_subject_baseline.csv")
    assert len(base) == 120 and set(base["visit_id"]) <= {"BL", "SC"}


def _cohort(kind, n, rng):
    if kind == "stratified":
        y = rng.randint(0, 2, n)
    elif kind == "one_class":
        y = np.ones(n, int)
    elif kind == "singleton":
        y = np.zeros(n, int)
        y[0] = 1
    else:  # imbalanced
        y = (rng.rand(n) < 0.15).astype(int)
    return pd.Series(y, index=[f"s{i}" for i in range(n)])


def _outcome(fn):
    try:
        return fn(), None
    except ValueError as exc:
        return None, type(exc)


@pytest.mark.parametrize("kind", ["stratified", "one_class", "singleton", "imbalanced"])
def test_create_splits_equal_the_jax_package(kind):
    for n in (2, 3, 5, 7, 17, 60, 151, 1500):
        labels = _cohort(kind, n, np.random.RandomState(n))
        for split_cfg in ({}, {"train_size": 0.6, "val_size": 0.2, "test_size": 0.2},
                          {"train_size": 0.67, "val_size": 0.16, "test_size": 0.17}):
            for seeds in ([42, 43, 44, 45, 46], [0, 7]):
                want = _outcome(lambda: J.create_splits(labels, seeds, split_cfg))
                got = _outcome(lambda: T.create_splits(labels, seeds, split_cfg))
                assert got == want, (kind, n, split_cfg, seeds)


def test_train_test_split_positions_equal_scikit_learn():
    from sklearn.model_selection import train_test_split

    for n, size in ((10, 0.7), (31, 0.5), (31, 17), (100, 3), (257, 0.33)):
        y = np.random.RandomState(n).randint(0, 3, n)
        for stratify in (None, y):
            for seed in (0, 42):
                want = train_test_split(np.arange(n), train_size=size, stratify=stratify,
                                        random_state=seed)
                got = train_test_split_positions(n, train_size=size, stratify=stratify,
                                                 seed=seed)
                np.testing.assert_array_equal(got[0], want[0])
                np.testing.assert_array_equal(got[1], want[1])
                want = train_test_split(np.arange(n), test_size=size, stratify=stratify,
                                        random_state=seed)
                got = train_test_split_positions(n, test_size=size, stratify=stratify,
                                                 seed=seed)
                np.testing.assert_array_equal(got[0], want[0])
                np.testing.assert_array_equal(got[1], want[1])


def test_build_script_runs_as_a_module_with_overrides(study_dir, tmp_path):  # noqa: F811
    """``python -m pd_fusion_torch.scripts.ppmi_build_dataset --config ...
    --seed 7 --out_dir D``: one split file for the overriding seed, and the
    run log beside the artifacts."""
    import yaml

    raw, _ = study_dir
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(_config(raw, tmp_path / "ignored")))
    out = tmp_path / "built"
    run = subprocess.run([sys.executable, "-m", "pd_fusion_torch.scripts.ppmi_build_dataset",
                          "--config", str(cfg_path), "--seed", "7", "--out_dir", str(out)],
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT_DIR / "src"), "PATH": "/usr/bin:/bin"})
    assert run.returncode == 0, run.stderr
    assert sorted(p.name for p in out.glob("ppmi_splits_seed*.json")) == ["ppmi_splits_seed7.json"]
    assert "Saved baseline ->" in (out / "ppmi_build_dataset.log").read_text()
