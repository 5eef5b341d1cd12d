"""The port's host half of the dev datasets against the JAX package's, on
fixture files the tests write: the UCI and OpenNeuro dev loaders,
``features/*``, the ``validate-data`` and ``prepare-dev`` subcommands, and
a short ``run --dataset uci_parkinsons`` CV through both CLIs (CPU). Frames
compare with ``pd.testing.assert_frame_equal`` and masks equal; the two CVs
write the same artifact files.
"""
import sys

import numpy as np
import pandas as pd
import pytest
import yaml

import pd_fusion.paths as jax_paths
from pd_fusion import cli as jax_cli
from pd_fusion.data.dev_datasets.openneuro import load_openneuro_dataset as jax_openneuro
from pd_fusion.data.dev_datasets.uci_parkinsons import load_uci_parkinsons as jax_uci
from pd_fusion.data.dev_datasets.uci_telemonitoring import load_uci_telemonitoring as jax_tele
from pd_fusion.experiments import run_experiment as JR
from pd_fusion_torch import cli
from pd_fusion_torch.data.dev_datasets.openneuro import load_openneuro_dataset
from pd_fusion_torch.data.dev_datasets.uci_parkinsons import load_uci_parkinsons, synthetic_frame
from pd_fusion_torch.data.dev_datasets.uci_telemonitoring import load_uci_telemonitoring
from pd_fusion_torch.experiments import run_experiment as TR
from pd_fusion_torch.paths import ROOT_DIR
from test_torch_port_jax_draws import one_cpu_thread

@pytest.fixture
def dev_dir(tmp_path, monkeypatch):
    """Both packages pointed at one fixture directory: the port reads the
    environment at each call, the JAX package its ``paths`` attribute."""
    monkeypatch.setenv("PD_FUSION_DEV_DATA_DIR", str(tmp_path))
    monkeypatch.setattr(jax_paths, "DEV_DATA_DIR", tmp_path)
    monkeypatch.setenv("PD_FUSION_TORCH_DEVICE", "cpu")
    (tmp_path / "uci").mkdir()
    with one_cpu_thread():
        yield tmp_path


def _same(got, want):
    pd.testing.assert_frame_equal(got[0], want[0])
    assert set(got[1]) == set(want[1]) == {"clinical", "datspect", "mri"}
    for k in got[1]:
        np.testing.assert_array_equal(got[1][k], want[1][k])


def test_uci_parkinsons_matches_jax(dev_dir):
    synthetic_frame().to_csv(dev_dir / "uci" / "parkinsons.data", index=False)
    got = load_uci_parkinsons()
    _same(got, jax_uci())
    assert "clinical_MDVP:Fo(Hz)" in got[0] and got[1]["clinical"].sum() == 195


def test_uci_telemonitoring_matches_jax(dev_dir):
    rng = np.random.RandomState(1)
    n = 50
    pd.DataFrame({"subject#": rng.randint(1, 10, n), "age": rng.rand(n) * 30 + 50,
                  "sex": rng.randint(0, 2, n), "test_time": rng.rand(n) * 100,
                  "motor_UPDRS": rng.rand(n) * 30, "total_UPDRS": rng.rand(n) * 40,
                  "Jitter(%)": rng.rand(n)}).to_csv(dev_dir / "uci" / "parkinsons_updrs.data",
                                                    index=False)
    got = load_uci_telemonitoring()
    _same(got, jax_tele())
    assert set(got[0]["diagnosis"]) == {0, 1} and "clinical_total_UPDRS" not in got[0]


@pytest.mark.parametrize("accession", ["ds004471", "ds004392"])
def test_openneuro_dev_loader_matches_jax(dev_dir, accession):
    root = dev_dir / "openneuro" / accession
    root.mkdir(parents=True)
    rng = np.random.RandomState(2)
    n = 30
    pd.DataFrame({"participant_id": [f"sub-{i:02d}" for i in range(n)],
                  "group": rng.choice(["PD", "Control", "n/a"], n),
                  "age": rng.rand(n) * 30 + 50, "sex": rng.choice(["M", "F", "x"], n),
                  "site": rng.choice(["a", "b"], n)}).to_csv(root / "participants.tsv", sep="\t",
                                                             index=False)
    for i in range(6):  # a few BIDS subjects with images of several kinds
        anat = root / f"sub-{i:02d}" / "anat"
        anat.mkdir(parents=True)
        (anat / f"sub-{i:02d}_T1w.nii.gz").write_bytes(b"x")
        if i % 2:
            (anat / f"sub-{i:02d}_T2w.nii").write_bytes(b"x")
            fmap = root / f"sub-{i:02d}" / "fmap"
            fmap.mkdir()
            (fmap / f"sub-{i:02d}_epi.nii.gz").write_bytes(b"x")
    got = load_openneuro_dataset(accession)
    _same(got, jax_openneuro(accession))
    kept = got[0]["patno"].str[4:].astype(int)  # the rows whose label mapped
    assert got[1]["mri"].sum() == (kept < 6).sum() > 0


def test_dev_loaders_raise_as_jax_without_their_files(dev_dir):
    for port, jax_fn in ((load_uci_parkinsons, jax_uci), (load_uci_telemonitoring, jax_tele),
                         (lambda: load_openneuro_dataset("ds004471"),
                          lambda: jax_openneuro("ds004471"))):
        with pytest.raises(FileNotFoundError):
            jax_fn()
        with pytest.raises(FileNotFoundError, match="download-dev"):
            port()


@pytest.mark.parametrize("dataset", ["uci_parkinsons", "openneuro_ds004471", "ds004392"])
def test_load_dataset_dispatch_matches_jax(dev_dir, dataset):
    synthetic_frame().to_csv(dev_dir / "uci" / "parkinsons.data", index=False)
    for acc in ("ds004471", "ds004392"):
        root = dev_dir / "openneuro" / acc
        root.mkdir(parents=True)
        pd.DataFrame({"participant_id": ["sub-01", "sub-02", "sub-03"],
                      "diagnosis": ["PD", "HC", "PD"], "age": [61, 70, 55]}).to_csv(
            root / "participants.tsv", sep="\t", index=False)
    got = TR.load_dataset({"dataset": dataset}, {}, False)
    want = JR.load_dataset({"dataset": dataset}, {}, False)
    assert got[0] == want[0] == dataset
    _same(got[1:], want[1:])
    with pytest.raises(ValueError, match="Unknown dataset"):
        TR.load_dataset({"dataset": "nope"}, {}, False)


def test_feature_helpers_match_jax():
    from pd_fusion.features import clinical as JC, datspect as JD, mri as JM
    from pd_fusion_torch.features import clinical, datspect, mri

    df = pd.DataFrame({"updrs_iii": ["12", "x", 30, None], "age": [60, "70", None, 81],
                       "sex": ["M", "F", "other", 1], "education": [12, 14, 16, 10],
                       "irrelevant": [1, 2, 3, 4]})
    pd.testing.assert_frame_equal(clinical.get_clinical_features(df),
                                  JC.get_clinical_features(df))
    roi = pd.DataFrame({"caudate_l": [2.0, 1.0], "caudate_r": [1.0, 1.0],
                        "putamen_l": [1.0, 0.5], "putamen_r": [1.0, 0.7], "sbr_mean": [1.2, 0.9],
                        "other": [0, 1]})
    pd.testing.assert_frame_equal(datspect.get_datspect_features(roi),
                                  JD.get_datspect_features(roi))
    vol = pd.DataFrame({"patno": [1, 2], "event_id": ["BL", "V04"], "icv": [1500.0, 1400.0],
                        "hippocampus_l": [4000.0, 3900.0], "site": ["a", "b"]})
    pd.testing.assert_frame_equal(mri.get_mri_features(vol), JM.get_mri_features(vol))
    pd.testing.assert_frame_equal(mri.get_mri_features(vol.drop(columns="icv")),
                                  JM.get_mri_features(vol.drop(columns="icv")))


def test_validate_data_writes_the_jax_packages_parquet(tmp_path, monkeypatch):
    """Raw PPMI-like CSVs (tests/test_validate_data.py's) through both CLIs'
    ``validate-data``: the same merged parquet."""
    import pd_fusion.data.ppmi_loader as JL
    import pd_fusion_torch.data.ppmi_loader as TL

    raw = tmp_path / "raw"
    raw.mkdir()
    pd.DataFrame({"PATNO": [1, 2, 3, 4], "EVENT_ID": "BL", "NP3TOT": [20, 5, 15, 30],
                  "AGE": [65, 60, 70, 55], "SEX": [1, 0, 1, 0],
                  "EDUCYRS": [12, 16, 14, 12]}).to_csv(raw / "clinical_baseline.csv", index=False)
    pd.DataFrame({"PATNO": [1, 2, 3], "EVENT_ID": "BL", "CAUDATE_R": [1.1, 2.5, 1.3],
                  "CAUDATE_L": [1.0, 2.4, 1.2], "PUTAMEN_R": [0.8, 2.0, 0.9],
                  "PUTAMEN_L": [0.7, 1.9, 0.8], "SBR_MEAN": [0.9, 2.2, 1.05]}).to_csv(
        raw / "datspect_sbr.csv", index=False)
    pd.DataFrame({"PATNO": [1, 4], "EVENT_ID": "BL", "L_Hippocampus_Vol": [4000.0, 4200.0],
                  "R_Hippocampus_Vol": [4100.0, 4150.0]}).to_csv(raw / "mri_volumetric.csv",
                                                                 index=False)
    data_config = {"raw_data_dir": str(raw), "modalities": {
        "clinical": {"files": ["clinical_baseline.csv"], "id_col": "PATNO"},
        "datspect": {"files": ["datspect_sbr.csv"], "id_col": "PATNO"},
        "mri": {"files": ["mri_volumetric.csv"], "id_col": "PATNO"}}}
    config = tmp_path / "data.yaml"
    config.write_text(yaml.safe_dump(data_config))
    columns = str(ROOT_DIR / "configs" / "ppmi_columns.yaml")
    monkeypatch.setattr(TL, "PROCESSED_DATA_DIR", tmp_path / "port")
    monkeypatch.setattr(JL, "PROCESSED_DATA_DIR", tmp_path / "jax")
    cli.main(["validate-data", "--config", str(config), "--columns", columns])
    monkeypatch.setattr(sys, "argv", ["pd_fusion", "validate-data", "--config", str(config),
                                      "--columns", columns])
    jax_cli.main()
    got, want = (pd.read_parquet(tmp_path / d / "ppmi_merged.parquet") for d in ("port", "jax"))
    pd.testing.assert_frame_equal(got, want)
    assert len(got) == 4 and {"updrs_iii", "hippocampus_l"} <= set(got.columns)


def test_prepare_dev_prints_what_the_jax_cli_prints(dev_dir, monkeypatch, capsys):
    synthetic_frame().to_csv(dev_dir / "uci" / "parkinsons.data", index=False)
    shapes = cli.main(["prepare-dev"])
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["pd_fusion", "prepare-dev"])
    jax_cli.main()
    jax_out = capsys.readouterr().out
    assert port_out == jax_out
    assert "uci_parkinsons: OK shape=(195, 24) clinical=195/195" in port_out
    assert "uci_telemonitoring: UNAVAILABLE" in port_out
    assert shapes == {"uci_parkinsons": (195, 24), "uci_telemonitoring": None}


def test_download_dev_still_raises_naming_why(tmp_path, monkeypatch):
    """``download-dev`` is ported: it no longer raises, and with the UCI
    files on disk it fetches nothing (any fetch would raise here)."""
    import urllib.request

    def _no_network(*a, **k):  # pragma: no cover - must never run
        raise AssertionError("network touched despite existing files")

    monkeypatch.setattr(urllib.request, "urlopen", _no_network)
    for name in ("parkinsons.data", "parkinsons_updrs.data"):
        (tmp_path / "uci").mkdir(exist_ok=True)
        (tmp_path / "uci" / name).write_text("cached")
    cli.main(["download-dev", "--dataset", "uci", "--out", str(tmp_path)])
    assert (tmp_path / "uci" / "parkinsons.data").read_text() == "cached"


def test_run_dataset_uci_parkinsons_cv_through_both_clis(dev_dir, tmp_path):
    """``run --config configs/quickstart.yaml --dataset uci_parkinsons
    --k-fold 3`` in the port, and the JAX pipeline with the same overrides:
    the same artifact files, all scenarios finite where they are defined."""
    synthetic_frame().to_csv(dev_dir / "uci" / "parkinsons.data", index=False)
    config = str(ROOT_DIR / "configs" / "quickstart.yaml")
    agg = cli.main(["run", "--config", config, "--dataset", "uci_parkinsons", "--k-fold", "3",
                    "--output-dir", str(tmp_path / "own")])
    JR.run_cv_pipeline(config, k=3, overrides={"dataset": "uci_parkinsons",
                                               "output_dir": str(tmp_path / "jax")})
    own, jax_run = (sorted(p.name for p in (tmp_path / d).iterdir()) for d in ("own", "jax"))
    assert own == jax_run and "results_aggregated.yaml" in own
    assert np.isfinite(agg["full_observation"]["roc_auc"]["mean"])
    jax_agg = yaml.safe_load((tmp_path / "jax" / "results_aggregated.yaml").read_text())
    assert set(agg) == set(jax_agg)
    prov = yaml.safe_load((tmp_path / "own" / "provenance.yaml").read_text())
    assert prov["dataset"] == "uci_parkinsons"
