"""The port's embed path (``imaging/pipeline.py``, the ResNet2D builders and
scripts, the ``resnet2d`` feature mode) against the JAX package's, on the
same synthetic NIfTI volumes (CPU, small: 16^3 targets, 32^2 inputs,
ResNet-18, bags of up to 9 slices).

- ``run_resnet_embedding_pipeline`` fed the JAX backbone
  (``params_from_jax``): mean-pooled, per-slice, multi-axis, ``tta: 2``
  and the float16 wire mode, within rtol 1e-4, atol 1e-5 (float32
  convolutions summed in other orders over 18 layers; the embeddings are
  of order 1);
- each subject's embedding does not depend on the flushes it went through
  (flush widths 1, 4, 7), within the same tolerance;
- the builders' artifact names, keys and meta JSON equal the JAX
  package's, and each package loads the other's caches;
- the port's scripts, then the port's CLI, for the MIL config (through
  K1's plain version here) and the ``resnet2d`` config (``fusion_moddrop``:
  the clinical and DaT groups have no columns and all-zero masks); fed the
  JAX package's draws, the ``resnet2d`` CV gives the JAX run's metrics
  to 1e-3.
"""
import json

import jax
import numpy as np
import pandas as pd
import pytest
import yaml

from pd_fusion.data import openneuro_features as JF
from pd_fusion.experiments import run_experiment as JR
from pd_fusion.imaging import pipeline as JP
from pd_fusion.nn import resnet as JRN
from pd_fusion_torch.data import openneuro_features as TF
from pd_fusion_torch.experiments import run_experiment as TR
from pd_fusion_torch.imaging import pipeline as TP
from pd_fusion_torch.imaging.nifti import write_nifti
from pd_fusion_torch.nn import resnet as TRN
from pd_fusion_torch.ops import attention_pool as ap
from pd_fusion_torch.paths import ROOT_DIR
from test_torch_port_jax_draws import one_cpu_thread, use_jax_draws

RTOL, ATOL = 1e-4, 1e-5
N_SUBJECTS = 12
SMALL = {"backbone": "resnet18", "target_shape": [16, 16, 16], "input_size": 32}
CASES = {
    "mean-pooled": dict(axes=[2], counts=[4], per_slice=False, tta=1),
    "per-slice-multi-axis": dict(axes=[0, 1, 2], counts=[2, 3, 4], per_slice=True, tta=1),
    "tta2-multi-axis": dict(axes=[0, 2], counts=[3, 4], per_slice=True, tta=2),
    "tta2-mean-pooled": dict(axes=[1], counts=[5], per_slice=False, tta=2),
}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("PD_FUSION_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("PD_FUSION_NO_NATIVE", raising=False)
    monkeypatch.delenv("PD_FUSION_PUT_DTYPE", raising=False)
    with one_cpu_thread():
        yield


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """12 subjects x 2 sessions, int16 with a scl_slope, session 1 gzipped
    and session 2 plain; PD subjects carry a darker deep region."""
    root = tmp_path_factory.mktemp("embed_ds")
    rng = np.random.RandomState(0)
    rows = []
    for s in range(N_SUBJECTS):
        label = s % 2
        for session in (1, 2):
            vol = rng.rand(22, 26, 20) * 150
            vol[2:20, 2:24, 2:18] += 600
            if label:
                vol[8:14, 9:15, 7:12] *= 0.7
            ext = ".nii.gz" if session == 1 else ".nii"
            p = root / f"sub-{s:02d}_ses-{session}_T1w{ext}"
            write_nifti(p, np.round(vol / 0.5).astype(np.int16), scl_slope=0.5)
            rows.append({"subject_id": f"sub-{s:02d}", "session": session, "label": label,
                         "t1wbrain_path": str(p)})
    manifest = root / "manifest.csv"
    pd.DataFrame(rows).to_csv(manifest, index=False)
    return root, manifest, rows


@pytest.fixture(scope="module")
def backbone():
    jp = jax.tree_util.tree_map(np.asarray, JRN.init_resnet(jax.random.PRNGKey(0), "resnet18"))
    return jp, TRN.params_from_jax(jp)


def _run(mod, params, rows, case, **extra):
    kw = dict(CASES[case])
    return np.stack(mod.run_resnet_embedding_pipeline(
        [r["t1wbrain_path"] for r in rows], [r["subject_id"] for r in rows], params,
        np.full(3, 0.5, np.float32), np.full(3, 0.5, np.float32), arch="resnet18",
        target_shape=tuple(SMALL["target_shape"]), input_size=SMALL["input_size"],
        progress=False, **kw, **extra))


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_matches_jax(dataset, backbone, case):
    _, _, rows = dataset
    jp, tp = backbone
    want = _run(JP, jp, rows, case)
    got = _run(TP, tp, rows, case)
    n_slices = sum(CASES[case]["counts"])
    assert got.shape == want.shape == ((len(rows), n_slices, 512) if CASES[case]["per_slice"]
                                       else (len(rows), 512))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert set(TP.LAST_PROFILE) == set(JP.LAST_PROFILE) == {
        "iter_wait_s", "device_put_s", "dispatch_s", "final_fetch_s"}


@pytest.mark.parametrize("per_slice", [False, True], ids=["mean-pooled", "per-slice"])
def test_embed_programs_match_jax(backbone, per_slice):
    """``embed_slices_batch`` (float32) and ``embed_slices_batch_augmented``
    on the same [B, L, h, w] slices and the same TTA draws."""
    import jax.numpy as jnp
    import torch

    jp, tp = backbone
    rng = np.random.RandomState(4)
    slices = rng.rand(3, 4, 16, 16).astype(np.float32)
    half = np.full(3, 0.5, np.float32)
    want = JP.embed_slices_batch(jp, jnp.asarray(slices), half, half, "resnet18", 32, per_slice)
    with torch.inference_mode():
        got = TP.embed_slices_batch(tp, torch.from_numpy(slices), torch.from_numpy(half),
                                    torch.from_numpy(half), "resnet18", 32, per_slice)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    draw = TP.tta_draws(["a", "b", "c"], 1, 4, 16, 16, 8.0, 0.05, 0.15, 0.15, 0.02)[0]
    want = JP.embed_slices_batch_augmented(jp, jnp.asarray(slices), half, half,
                                           *map(jnp.asarray, draw), "resnet18", 32, per_slice)
    with torch.inference_mode():
        got = TP.embed_slices_batch_augmented(
            tp, torch.from_numpy(slices), torch.from_numpy(half), torch.from_numpy(half),
            *map(torch.from_numpy, draw), "resnet18", 32, per_slice)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_float16_wire_mode_matches_jax(dataset, backbone, monkeypatch):
    _, _, rows = dataset
    jp, tp = backbone
    monkeypatch.setenv("PD_FUSION_PUT_DTYPE", "f16")
    want = _run(JP, jp, rows, "per-slice-multi-axis")
    got = _run(TP, tp, rows, "per-slice-multi-axis")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["per-slice-multi-axis", "tta2-multi-axis"])
def test_each_subject_gets_the_embedding_it_gets_alone(dataset, backbone, case):
    """Flushes of 1, of 4 (the default) and of 7 (24 rows: 7, 7, 7, 3) give
    every row the same embedding, its TTA draws included."""
    _, _, rows = dataset
    _, tp = backbone
    alone = _run(TP, tp, rows, case, subjects_per_call=1)
    for width in (None, 7):
        np.testing.assert_allclose(_run(TP, tp, rows, case, subjects_per_call=width), alone,
                                   rtol=RTOL, atol=ATOL)


def test_numpy_mirror_prep_gives_the_native_embeddings(dataset, backbone, monkeypatch):
    """PD_FUSION_NO_NATIVE=1 is the only way to the numpy mirrors."""
    _, _, rows = dataset
    _, tp = backbone
    native_emb = _run(TP, tp, rows, "mean-pooled")
    monkeypatch.setenv("PD_FUSION_NO_NATIVE", "1")
    np.testing.assert_allclose(_run(TP, tp, rows, "mean-pooled"), native_emb, rtol=RTOL,
                               atol=ATOL)


def _tree(d):
    return sorted(p.name for p in d.iterdir())


@pytest.mark.parametrize("kind", ["mean-pooled", "mil"])
def test_builders_write_the_jax_packages_artifacts(dataset, tmp_path, kind):
    root, manifest, rows = dataset
    cfg = dict(SMALL, slice_axes=[0, 2], slice_counts=[2, 3], tta=2) if kind == "mil" else dict(
        SMALL, slice_axis=2, slice_count=4)
    tdir, jdir = tmp_path / "port", tmp_path / "jax"
    if kind == "mil":
        t_out = TF.build_resnet2d_mil_embeddings(manifest, tdir, cfg)
        j_out = JF.build_resnet2d_mil_embeddings(manifest, jdir, cfg)
        assert t_out.name == j_out.name
        with np.load(t_out, allow_pickle=True) as t, np.load(j_out, allow_pickle=True) as j:
            assert sorted(t.files) == sorted(j.files) == ["embeddings", "label", "session",
                                                          "subject_id"]
            for k in t.files:
                assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
            assert t["embeddings"].shape == (len(rows), 5, 512)
        frames = [load(manifest, d, cfg) for load in (TF.load_resnet2d_mil_embeddings,
                                                      JF.load_resnet2d_mil_embeddings)
                  for d in (tdir, jdir)]
        for f in frames:
            assert list(f.columns) == ["subject_id", "session", "label", "mri_mil"]
    else:
        t_df = TF.build_resnet2d_embeddings(manifest, tdir, cfg)
        j_df = JF.build_resnet2d_embeddings(manifest, jdir, cfg)
        assert list(t_df.columns) == list(j_df.columns)
        assert list(t_df.dtypes) == list(j_df.dtypes)
        pd.testing.assert_frame_equal(TF.load_resnet2d_embeddings(manifest, jdir, cfg), j_df)
        pd.testing.assert_frame_equal(JF.load_resnet2d_embeddings(manifest, tdir, cfg), t_df)
    assert _tree(tdir) == _tree(jdir)
    meta_t, meta_j = (json.loads(next(d.glob("*.json")).read_text()) for d in (tdir, jdir))
    assert meta_t == meta_j


def _configs(tmp_path, manifest, cache, config_name, emb_cfg, **overrides):
    """Copies of a repo config and its data config pointed at ``manifest``
    and ``cache``, the embedding settings replaced by ``emb_cfg``."""
    cfg = yaml.safe_load((ROOT_DIR / "configs" / config_name).read_text())
    data_cfg = yaml.safe_load((ROOT_DIR / cfg["data_config"]).read_text())
    data_cfg.update(manifest_path=str(manifest), resnet2d_cache_dir=str(cache),
                    resnet2d_config=emb_cfg)
    (tmp_path / "data.yaml").write_text(yaml.safe_dump(data_cfg))
    cfg.update(data_config=str(tmp_path / "data.yaml"), **overrides)
    path = tmp_path / config_name
    path.write_text(yaml.safe_dump(cfg))
    return path


MIL_SMALL = {"hidden_dim": 16, "attn_dim": 8, "dropout": 0.2, "gated": True,
             "class_weight": "balanced", "lr": 0.01, "batch_size": 8, "epochs": 3,
             "early_stopping_patience": 3, "max_grad_norm": 1.0, "weight_decay": 0.001,
             "missing_prob": 0.5}


def test_mil_builder_script_then_cli(dataset, tmp_path):
    from pd_fusion_torch import cli
    from pd_fusion_torch.scripts import build_resnet2d_mil_embeddings as script

    _, manifest, rows = dataset
    cache = tmp_path / "emb"
    argv = ["--manifest", str(manifest), "--out-dir", str(cache), "--backbone", "resnet18",
            "--target-shape", "16", "16", "16", "--slice-count", "6", "--input-size", "32"]
    out = script.main(argv)
    emb_cfg = script.config_from_args(script.parse_args(argv))
    # the YAML form of the same settings finds the artifact, in both packages
    config = _configs(tmp_path, manifest, cache, "openneuro_ds001907_resnet2d_mil.yaml",
                      emb_cfg, params=MIL_SMALL, calibration_split=0.25)
    data_cfg = yaml.safe_load((tmp_path / "data.yaml").read_text())["resnet2d_config"]
    assert JF._cache_stem("resnet2d_mil", manifest, data_cfg) == out.stem
    assert len(JF.load_resnet2d_mil_embeddings(manifest, cache, data_cfg)) == len(rows)

    ap.reset_launch_counts()
    agg = cli.main(["run", "--config", str(config), "--k-fold", "2", "--output-dir",
                    str(tmp_path / "run")])
    assert len(agg) == 7 and np.isfinite(agg["full_observation"]["roc_auc"]["mean"])
    assert ap.launch_counts["plain"] > 0 and ap.launch_counts["kernel"] == 0  # CPU tensors


def test_resnet2d_builder_script_then_moddrop_cv_matches_jax(dataset, tmp_path, monkeypatch):
    """The mean-pooled builder, then the ``resnet2d`` config's calibrated
    ``fusion_moddrop`` CV, whose clinical and DaT groups are empty. The
    port's own run and the JAX run write the same artifacts; fed the JAX
    draws, the port gives the JAX run's metrics to 1e-3."""
    from pd_fusion_torch import cli
    from pd_fusion_torch.data.openneuro_ds001907 import load_openneuro_ds001907
    from pd_fusion_torch.scripts import build_resnet2d_embeddings as script

    _, manifest, rows = dataset
    cache = tmp_path / "emb"
    argv = ["--manifest", str(manifest), "--out-dir", str(cache), "--target-shape", "16", "16",
            "16", "--slice-count", "4", "--input-size", "32"]
    script.main(argv)
    emb_cfg = script.config_from_args(script.parse_args(argv))
    params = {"hidden_dims": [12, 6], "dropout": 0.2, "lr": 0.02, "batch_size": 8, "epochs": 6,
              "moddrop_rate": 0.3, "weight_decay": 0.0005}
    config = _configs(tmp_path, manifest, cache, "openneuro_ds001907_resnet2d.yaml", emb_cfg,
                      params=params, cv_plot_example=False)
    data_cfg = yaml.safe_load((tmp_path / "data.yaml").read_text())
    df, masks = load_openneuro_ds001907(data_cfg)
    assert masks["mri"].sum() == len(rows) and not masks["clinical"].any()
    assert not masks["datspect"].any() and sum(c.startswith("mri_resnet_") for c in df) == 512

    monkeypatch.setenv("PD_FUSION_HOST_ISOTONIC", "1")
    agg = cli.main(["run", "--config", str(config), "--k-fold", "2", "--output-dir",
                    str(tmp_path / "own")])
    assert len(agg) == 7 and np.isfinite(agg["full_observation"]["roc_auc"]["mean"])
    JR.run_cv_pipeline(str(config), k=2, overrides={"output_dir": str(tmp_path / "jax")})
    assert _tree(tmp_path / "own") == _tree(tmp_path / "jax")
    use_jax_draws(monkeypatch)
    TR.run_cv_pipeline(str(config), k=2, overrides={"output_dir": str(tmp_path / "seam")})
    for i in (1, 2):
        jf, sf = (yaml.safe_load((tmp_path / d / f"results_fold_{i}.yaml").read_text())
                  for d in ("jax", "seam"))
        for scen in jf:
            if scen != "fold":
                for metric, v in jf[scen].items():
                    if np.isfinite(v):
                        assert sf[scen][metric] == pytest.approx(v, abs=1e-3), (scen, metric)
                    else:
                        assert not np.isfinite(sf[scen][metric]), (scen, metric)
