"""The port's tabular data layer (pd_fusion_torch/data/ppmi_loader.py,
preprocess.py, feature_utils.py, column_mapping.py) against the JAX
package's, bit for bit: the synthetic frame and masks, the NaN-robust
scaler, ``preprocess_features`` and every feature utility. The torch
forms of ``_scale_transform`` and ``apply_modality_masks`` match the
jitted JAX functions to 0 ulp."""
import hashlib

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from pd_fusion.data import feature_utils as JF
from pd_fusion.data import ppmi_loader as JL
from pd_fusion.data import preprocess as JP
from pd_fusion.utils.seed import set_seed as jax_set_seed
from pd_fusion_torch.data import feature_utils as TF
from pd_fusion_torch.data import ppmi_loader as TL
from pd_fusion_torch.data import preprocess as TP
from pd_fusion_torch.data.schema import MODALITIES
from pd_fusion_torch.utils.seed import set_seed

# tests/test_parity_reference.py pins the seed-42 frame of this config
SYNTH_CFG = {"num_samples": 500, "clinical_dim": 10, "datspect_dim": 5, "mri_dim": 20,
             "missing_rates": [0.1, 0.3, 0.4]}
GOLDEN_SHA = "be20614731c8e300da87a83bb3afc52a7347658a9e3f3328be9808c7861237bd"


def _synthetic(seed, cfg=SYNTH_CFG):
    set_seed(seed)
    return TL.generate_synthetic_data(cfg)


def test_seed_42_frame_hashes_to_the_golden_sha_and_equals_jax():
    df, masks = _synthetic(42)
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(df.to_numpy(dtype=np.float64)).tobytes())
    for m in MODALITIES:
        h.update(masks[m].astype(np.int64).tobytes())
    assert h.hexdigest() == GOLDEN_SHA

    jax_set_seed(42)
    jdf, jmasks = JL.generate_synthetic_data(SYNTH_CFG)
    pd.testing.assert_frame_equal(df, jdf, check_exact=True)
    for m in MODALITIES:
        np.testing.assert_array_equal(masks[m], jmasks[m])


@pytest.mark.parametrize("seed", [0, 7])
def test_other_seeds_and_dims_equal_jax(seed):
    cfg = {"num_samples": 37, "clinical_dim": 3, "mri_dim": 1, "missing_rates": [0.5, 0.0, 1.0]}
    df, masks = _synthetic(seed, cfg)
    jax_set_seed(seed)
    jdf, jmasks = JL.generate_synthetic_data(cfg)
    pd.testing.assert_frame_equal(df, jdf, check_exact=True)
    assert all(np.array_equal(masks[m], jmasks[m]) for m in MODALITIES)


def test_load_ppmi_data_synthetic_and_masks_from_markers():
    set_seed(3)
    got = TL.load_ppmi_data({"synthetic": SYNTH_CFG}, synthetic=True)
    jax_set_seed(3)
    want = JL.load_ppmi_data({"synthetic": SYNTH_CFG}, synthetic=True)
    pd.testing.assert_frame_equal(got[0], want[0], check_exact=True)
    df = pd.DataFrame({"updrs_iii": [1.0, np.nan, np.nan], "age": [np.nan, 50.0, np.nan],
                       "hippocampus_l": [np.nan, np.nan, 2.0]})
    for a, b in zip(TL.create_masks_from_df(df, {}).items(), JL.create_masks_from_df(df, {}).items()):
        assert a[0] == b[0] and np.array_equal(a[1], b[1])


def test_column_mapper_matches_jax(tmp_path):
    from pd_fusion.data.column_mapping import load_and_validate_raw_data as jax_load
    from pd_fusion_torch.data.column_mapping import load_and_validate_raw_data

    (tmp_path / "a.csv").write_text("PATNO,AGE,X\n1,60,3\n2,70,4\n")
    (tmp_path / "b.csv").write_text("PATNO,SBR\n1,2.5\n")
    data_cfg = {"raw_data_dir": str(tmp_path), "modalities": {
        "clinical": {"files": ["a.csv", "missing.csv"]}, "datspect": {"files": ["b.csv"]},
        "mri": {"files": ["b.csv"]}}}
    col_cfg = {"clinical": {"required_columns": ["PATNO", "AGE"],
                            "column_map": {"PATNO": "patno", "AGE": "age"}},
               "datspect": {"required_columns": ["SBR"], "column_map": {"SBR": "sbr_mean"}},
               "mri": {"required_columns": ["HIPPO"]}}
    got, want = load_and_validate_raw_data(data_cfg, col_cfg), jax_load(data_cfg, col_cfg)
    assert got.keys() == want.keys() == {"clinical", "datspect"}
    for k in got:
        pd.testing.assert_frame_equal(got[k], want[k])


def _nan_heavy(seed):
    """NaN-heavy matrix: an all-NaN column, even and odd non-NaN counts,
    heavy ties, a constant column (zero IQR) and huge values."""
    rng = np.random.RandomState(seed)
    X = rng.randn(41, 8)
    X[rng.rand(41, 8) < 0.35] = np.nan
    X[:, 0] = np.nan  # all NaN
    X[:, 1] = np.round(X[:, 1])  # ties
    X[:20, 2] = np.nan  # 21 values: odd count
    X[:21, 3] = np.nan  # 20 values: even count
    X[:, 4] = 3.0  # constant: IQR 0
    X[::3, 5] = 1e300
    X[:, 6] = rng.randint(0, 3, 41).astype(float)
    return X


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nan_median_quartiles_and_scaler_are_bit_identical(seed):
    X = _nan_heavy(seed)
    for a, b in zip(TP._nan_median_quartiles(X), JP._nan_median_quartiles(X)):
        np.testing.assert_array_equal(a, b)
    got, want = TP.NaNRobustScaler().fit(X), JP.NaNRobustScaler().fit(X)
    np.testing.assert_array_equal(got.medians, want.medians)
    np.testing.assert_array_equal(got.iqrs, want.iqrs)
    Xt = _nan_heavy(seed + 10)
    np.testing.assert_array_equal(got.transform(Xt), want.transform(Xt))
    with pytest.raises(ValueError):
        TP.NaNRobustScaler().transform(Xt)


def test_preprocess_features_matches_with_missing_columns_and_absent_modality():
    df, _ = _synthetic(5)
    df["clinical_text"] = ["1.5", "x"] * 250  # non-numeric: the per-column path
    cols = ["clinical_f0", "nope", "datspect_f1", "mri_f3"]
    for c in (cols, cols + ["clinical_text"]):
        got, _, scaler = TP.preprocess_features(df.iloc[:300], c)
        want, _, jscaler = JP.preprocess_features(df.iloc[:300], c)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype == np.float32
        assert (got[:, 1] == 0).all()  # the missing column is NaN, then 0
        np.testing.assert_array_equal(
            TP.preprocess_features(df.iloc[300:], c, None, scaler)[0],
            JP.preprocess_features(df.iloc[300:], c, None, jscaler)[0])
    got, _, s = TP.preprocess_features(df, ["other_a", "other_b"])
    want, _, _ = JP.preprocess_features(df, ["other_a", "other_b"])
    assert s is None and got.shape == (500, 2) and not got.any()
    np.testing.assert_array_equal(got, want)


def _schema_frame():
    return pd.DataFrame({
        "age": [1.0, 2.0], "sbr_mean": [0.5, 0.1], "clinical_x": [3.0, 4.0],
        "mri_f0": [0.0, 1.0], "hippocampus_l": [2.0, 2.0], "diagnosis": [0, 1],
    })


def test_feature_utils_match_jax_exactly():
    frames = [_synthetic(1)[0], _schema_frame(), _schema_frame().drop(columns="clinical_x")]
    for df in frames:
        for m in MODALITIES:
            assert TF.get_modality_feature_cols(df, m) == JF.get_modality_feature_cols(df, m)
        cols = TF.get_all_feature_cols(df)
        assert cols == JF.get_all_feature_cols(df)
        cols = cols + ["unassigned", "updrs_iii"]
        assert TF.get_feature_slices(cols) == JF.get_feature_slices(cols)
        np.testing.assert_array_equal(TF.feature_modality_matrix(cols),
                                      JF.feature_modality_matrix(cols))

    df, masks = _synthetic(2)
    cols = TF.get_all_feature_cols(df)
    X = np.nan_to_num(df[cols].to_numpy(np.float32))
    rng = np.random.RandomState(0)
    masks = {m: rng.randint(0, 2, len(df)) for m in MODALITIES}
    del masks["datspect"]  # a modality absent from the masks is zeroed
    np.testing.assert_array_equal(TF.apply_masks_to_matrix(X, masks, cols),
                                  JF.apply_masks_to_matrix(X, masks, cols))
    assign = TF.feature_modality_matrix(cols)
    mm = rng.randint(0, 2, (len(df), 3)).astype(np.float32)
    np.testing.assert_array_equal(TF.apply_modality_masks_np(X, mm, assign),
                                  JF.apply_modality_masks_np(X, mm, assign))


def test_torch_scale_transform_and_mask_apply_match_jitted_jax_to_0_ulp():
    X = _nan_heavy(4).astype(np.float32)
    X[X > 1e30] = 7.0
    scaler = TP.NaNRobustScaler().fit(X)
    med, iqr = scaler.medians.astype(np.float32), scaler.iqrs.astype(np.float32)
    want = np.asarray(JP._scale_transform(jnp.asarray(X), jnp.asarray(med), jnp.asarray(iqr)))
    got = TP._scale_transform(torch.from_numpy(X), torch.from_numpy(med), torch.from_numpy(iqr))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.isnan(want).any()

    rng = np.random.RandomState(1)
    Xm = rng.randn(30, 9).astype(np.float32)
    assign = np.zeros((9, 3), np.float32)
    assign[:3, 0] = assign[3:5, 1] = assign[5:8, 2] = 1.0  # column 8 is never masked
    mm = rng.randint(0, 2, (30, 3)).astype(np.float32)
    want = np.asarray(JF.apply_modality_masks(jnp.asarray(Xm), jnp.asarray(mm), jnp.asarray(assign)))
    got = TF.apply_modality_masks(torch.from_numpy(Xm), torch.from_numpy(mm),
                                  torch.from_numpy(assign))
    np.testing.assert_array_equal(got.numpy(), want)
