"""The port's simple 3-D statistics (``ops/volume_stats.py``, the
``features_*`` builder and the ``simple`` feature mode) against the JAX
package's, on the same seeded numpy volumes and NIfTI files (CPU, small).

Tolerances are ``ops/volume_stats_checks.py``'s: the order statistics (min,
max, median, p10, p90) and the histogram equal; mean and std within rtol
1e-5; the grid within rtol 1e-5 plus 4e-6 of the volume's scale
(``resize3d``'s bound against the JAX function); skewness and kurtosis
within rtol 1e-5 plus 1e-5; entropy within rtol 1e-5. The builder's parquet
has the JAX package's name and columns, and each package's loader reads the
other's cache to the same frame.
"""
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from pd_fusion.data import openneuro_features as JF
from pd_fusion.data.openneuro_ds001907 import load_openneuro_ds001907 as jax_load
from pd_fusion.imaging import native as JN
from pd_fusion.ops.volume_stats import simple_volume_features as jax_features
from pd_fusion_torch.data import openneuro_features as TF
from pd_fusion_torch.data.openneuro_ds001907 import load_openneuro_ds001907 as port_load
from pd_fusion_torch.imaging.nifti import write_nifti
from pd_fusion_torch.ops import volume_stats_checks as checks
from pd_fusion_torch.ops.volume_stats import n_features, simple_volume_features
from test_torch_port_jax_draws import one_cpu_thread


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("PD_FUSION_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("PD_FUSION_NO_NATIVE", raising=False)
    with one_cpu_thread():
        yield


def _volumes():
    rng = np.random.RandomState(0)
    ties = np.round(rng.rand(16, 16, 16) * 4).astype(np.float32)  # many equal values
    ties[:2] = 0.0
    return {
        "seeded_16": rng.rand(16, 16, 16).astype(np.float32) - 0.2,
        "seeded_24x20x18": (rng.rand(24, 20, 18) * 600).astype(np.float32),
        "all_zero": np.zeros((16, 16, 16), np.float32),
        "constant": np.full((16, 16, 16), 1.7, np.float32),
        "ties_at_percentiles": ties,
        "all_negative": -rng.rand(16, 16, 16).astype(np.float32),
        "wide_range": (rng.rand(20, 22, 18) * 1000).astype(np.float32) - 100.0,
    }


VOLUMES = _volumes()


@pytest.mark.parametrize("extra_stats", [False, True], ids=["plain", "extra_stats"])
@pytest.mark.parametrize("name", list(VOLUMES))
def test_simple_volume_features_match_jax(name, extra_stats):
    vol = VOLUMES[name]
    for grid in (4, 8):
        want = np.asarray(jax_features(jnp.asarray(vol), 10, grid, extra_stats))
        got = simple_volume_features(torch.from_numpy(vol), 10, grid, extra_stats).numpy()
        assert got.dtype == np.float32 and got.shape == (n_features(10, grid, extra_stats),)
        checks.check_features(got, want, 10, grid, extra_stats, float(np.abs(vol).max()))


def test_degenerate_volumes_take_numpys_widened_range():
    """A constant volume and an all-zero one (which uses every voxel):
    ``np.histogram`` widens the degenerate range by 0.5 each way, so every
    voxel lands in the middle bin, at density 1 / 0.1."""
    for name in ("constant", "all_zero"):
        vol = VOLUMES[name]
        got = simple_volume_features(torch.from_numpy(vol), 10, 4).numpy()
        assert np.isfinite(got).all()
        c = float(vol.flat[0])
        want, _ = np.histogram(vol, bins=10, range=(c - 0.5, c + 0.5), density=True)
        np.testing.assert_allclose(got[7:17], want, rtol=1e-5)
        assert want[5] == pytest.approx(10.0)


def test_batched_call_gives_each_volume_its_own_row():
    vols = np.stack([VOLUMES[n] for n in ("seeded_16", "all_zero", "constant",
                                           "ties_at_percentiles")])
    batch = simple_volume_features(torch.from_numpy(vols), 10, 4, True).numpy()
    for i, v in enumerate(vols):
        np.testing.assert_array_equal(
            batch[i], simple_volume_features(torch.from_numpy(v), 10, 4, True).numpy())


@pytest.fixture(scope="module")
def synthetic_dataset(tmp_path_factory):
    """12 subjects, float32 volumes; PD subjects carry a bright blob (the JAX
    package's integration fixture, tests/test_imaging_integration.py)."""
    root = tmp_path_factory.mktemp("nifti_ds")
    rng = np.random.RandomState(0)
    rows = []
    for i in range(12):
        label = i % 2
        vol = rng.rand(24, 28, 26).astype(np.float32) * 0.3
        vol[2:22, 2:26, 2:24] += 0.4
        if label:
            vol[8:16, 8:16, 8:16] += 1.5
        p = root / f"sub-{i:02d}_T1w.nii.gz"
        write_nifti(p, vol)
        rows.append({"subject_id": f"sub-{i:02d}", "session": 1, "label": label,
                     "t1wbrain_path": str(p)})
    manifest = root / "manifest.csv"
    pd.DataFrame(rows).to_csv(manifest, index=False)
    # the JAX package builds its native library at first use, and its
    # prefetch threads that ask meanwhile fall back to another resize (one
    # ulp off): load it once here, so that both builders read the same volumes
    assert JN.read_resize_nifti_native(rows[0]["t1wbrain_path"], (4, 4, 4)) is not None
    return root, manifest


FEATURE_CONFIGS = {
    "grid4": {"target_shape": (16, 16, 16), "hist_bins": 10, "grid_size": 4},
    "yaml_like_extra": {"hist_bins": 10, "grid_size": 8, "target_shape": [20, 18, 16],
                        "extra_stats": True},
}


@pytest.mark.parametrize("cfg_name", list(FEATURE_CONFIGS))
def test_build_simple_features_matches_the_jax_builder(synthetic_dataset, tmp_path, cfg_name):
    """12 volumes in batches of 8 and 4 (the JAX builder pads the 4 to 8)."""
    _, manifest = synthetic_dataset
    cfg = FEATURE_CONFIGS[cfg_name]
    port = TF.build_simple_features(manifest, tmp_path / "port", cfg)
    jax_df = JF.build_simple_features(manifest, tmp_path / "jax", cfg)
    assert ([p.name for p in (tmp_path / "port").iterdir()]
            == [p.name for p in (tmp_path / "jax").iterdir()]
            == [f"{JF._cache_stem('features', manifest, cfg)}.parquet"])
    assert list(port.columns) == list(jax_df.columns) and list(port.dtypes) == list(jax_df.dtypes)
    feat = [c for c in port.columns if c.startswith("mri_feat_")]
    assert len(feat) == n_features(cfg["hist_bins"], cfg["grid_size"],
                                   cfg.get("extra_stats", False))
    pd.testing.assert_frame_equal(port.drop(columns=feat), jax_df.drop(columns=feat))
    checks.check_features(port[feat].to_numpy(np.float32), jax_df[feat].to_numpy(np.float32),
                          cfg["hist_bins"], cfg["grid_size"], cfg.get("extra_stats", False),
                          scale=2.2)  # the volumes' largest value, 0.3 + 0.4 + 1.5
    # each package's loader reads the other's cache to the same frame
    pd.testing.assert_frame_equal(TF.load_simple_features(manifest, tmp_path / "jax", cfg),
                                  jax_df)
    pd.testing.assert_frame_equal(JF.load_simple_features(manifest, tmp_path / "port", cfg),
                                  port)
    # a second call hits the cache
    pd.testing.assert_frame_equal(TF.build_simple_features(manifest, tmp_path / "port", cfg),
                                  port)


def test_simple_mode_gives_the_jax_loaders_frame_and_masks(synthetic_dataset, tmp_path,
                                                            monkeypatch):
    _, manifest = synthetic_dataset
    monkeypatch.setenv("PD_FUSION_DS001907_MANIFEST", str(manifest))
    cfg = {"feature_mode": "simple", "feature_cache_dir": str(tmp_path / "feat"),
           "feature_config": FEATURE_CONFIGS["grid4"]}
    want, want_masks = jax_load(cfg)  # builds the cache
    got, masks = port_load(cfg)  # reads it
    pd.testing.assert_frame_equal(got, want)
    assert set(masks) == set(want_masks) == {"clinical", "datspect", "mri"}
    for k in masks:
        np.testing.assert_array_equal(masks[k], want_masks[k])
    assert masks["mri"].sum() == 12 and not masks["clinical"].any()
    # the port's own build, read by both loaders
    cfg["feature_cache_dir"] = str(tmp_path / "port_feat")
    got, masks = port_load(cfg)
    want, want_masks = jax_load(cfg)
    pd.testing.assert_frame_equal(got, want)
    for k in masks:
        np.testing.assert_array_equal(masks[k], want_masks[k])


def test_a_frame_without_mri_columns_raises_as_in_jax(tmp_path, monkeypatch):
    from pd_fusion_torch.data import openneuro_ds001907 as T

    manifest = tmp_path / "m.csv"
    pd.DataFrame({"subject_id": ["a"], "session": [1], "label": [1],
                  "t1wbrain_path": ["x"]}).to_csv(manifest, index=False)
    monkeypatch.setenv("PD_FUSION_DS001907_MANIFEST", str(manifest))
    monkeypatch.setattr(TF, "load_simple_features",
                        lambda *a: pd.DataFrame({"subject_id": ["a"], "label": [1]}))
    with pytest.raises(ValueError, match="no mri_"):
        T.load_openneuro_ds001907({"feature_mode": "simple"})
    with pytest.raises(ValueError, match="unknown feature_mode"):
        T.load_openneuro_ds001907({"feature_mode": "radiomics"})
