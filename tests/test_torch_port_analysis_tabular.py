"""The port's suite analysis tier (``pd_fusion_torch/analysis/tabular.py``,
``analysis/column_transformer.py``) against the JAX package's
``pd_fusion/analysis/tabular.py`` and scikit-learn, on the same numpy and
pandas inputs (CPU).

Tolerances:
- the host helpers (``coerce_numeric``, ``grep_columns``,
  ``numeric_feature_columns``, ``TabularPrep``, ``CovariateCodec``,
  ``site_zscore``, the asymmetry helpers, ``paired_fold_ttest``): bit for
  bit; ``residualize_features`` (one ``lstsq``) to 1e-12;
- ``rank_univariate_auc``: the same ranking, AUCs within 1e-6;
- ``permutation_screen``: AUCs within 1e-5 of the JAX function's. The
  probes start at zero with balanced weights, so the bias's gradient is 0
  in exact arithmetic and its first Adam step is float32 rounding noise of
  each implementation; on most inputs the AUCs still come out equal, but
  where two held-out scores lie close one pair can order the other way:
  on ``tests/test_ppmi_suites.py``'s frame the full-column screen's second
  repeat does, so that frame is held to one pair per repeat;
- the sweep's preprocessing against scikit-learn's ``ColumnTransformer``
  (the JAX script's ``build_preprocessor``): bit for bit, with an unseen
  category, a column that is all NaN in train, tied modes, with and
  without scaling.
"""
import importlib.util
import warnings

import numpy as np
import pandas as pd
import pytest
import torch

from pd_fusion.analysis import tabular as JT
from pd_fusion_torch.analysis import tabular as TT
from pd_fusion_torch.analysis.column_transformer import SuiteColumnTransformer
from pd_fusion_torch.ops.metrics import roc_auc
from pd_fusion_torch.paths import ROOT_DIR
from test_ppmi_suites import baseline_df  # noqa: F401  (the JAX suites' fixture)
from test_torch_port_jax_draws import one_cpu_thread


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("PD_FUSION_TORCH_DEVICE", "cpu")
    with one_cpu_thread():
        yield


def _frame(n=160, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 2, n)
    df = pd.DataFrame({
        "subject_id": [str(i) for i in range(n)], "label": y,
        "moca__MCATOT": np.round(rng.randn(n) * 3 - y),  # ties
        "datscan__PUTAMEN_L": rng.rand(n) * 2 + (1 - y), "datscan__PUTAMEN_R": rng.rand(n) * 2,
        "mri__Left-Hippocampus": rng.randn(n), "mri__Right-Hippocampus": rng.randn(n) - 0.3 * y,
        "visit_date": "2016-01-01", "site": rng.choice(["A", "B", "C"], n),
        "age": rng.rand(n) * 30 + 50, "sex": rng.choice(["M", "F"], n),
        "text": rng.choice(["x", "y"], n), "empty": np.nan,
    })
    df.loc[rng.rand(n) < 0.2, ["datscan__PUTAMEN_L", "datscan__PUTAMEN_R"]] = np.nan
    df.loc[rng.rand(n) < 0.1, "mri__Left-Hippocampus"] = np.nan
    return df


FEATURES = ["moca__MCATOT", "datscan__PUTAMEN_L", "datscan__PUTAMEN_R", "mri__Left-Hippocampus",
            "mri__Right-Hippocampus", "age", "empty"]


def test_column_helpers_equal_the_jax_package():
    df = _frame()
    deny = [r"^.*date.*$", r"^.*site.*$"]
    ids = {"subject_id"}
    assert TT.numeric_feature_columns(df, deny, ids) == JT.numeric_feature_columns(df, deny, ids)
    cols = list(df.columns)
    for allow, deny in ((["datscan"], None), (None, [r"mri__"]), (["a"], ["age"])):
        assert TT.grep_columns(cols, allow, deny) == JT.grep_columns(cols, allow, deny)
    pd.testing.assert_frame_equal(TT.coerce_numeric(df, cols), JT.coerce_numeric(df, cols))
    assert TT.asymmetry_pairs(cols) == JT.asymmetry_pairs(cols)
    for a, b in zip(TT.with_asymmetry(df, cols), JT.with_asymmetry(df, cols)):
        if isinstance(a, pd.DataFrame):
            pd.testing.assert_frame_equal(a, b)
        else:
            assert a == b
    folds = ([0.81, 0.77, 0.9, 0.85], [0.8, 0.7, 0.88, 0.8])
    assert TT.paired_fold_ttest(*folds) == JT.paired_fold_ttest(*folds)
    assert TT.paired_fold_ttest([1.0], [1.0, 2.0]) is None


@pytest.mark.parametrize("scale,indicators", [(True, True), (True, False), (False, True)])
def test_tabular_prep_equals_the_jax_package(scale, indicators):
    df = _frame()
    tr, te = df.iloc[:120], df.iloc[120:]
    a = TT.TabularPrep(scale=scale, add_indicators=indicators)
    b = JT.TabularPrep(scale=scale, add_indicators=indicators)
    np.testing.assert_array_equal(a.fit_transform(tr, FEATURES), b.fit_transform(tr, FEATURES))
    np.testing.assert_array_equal(a.transform(te), b.transform(te))
    assert a.feature_names == b.feature_names


def test_covariates_residualize_and_site_zscore_equal_the_jax_package():
    df = _frame()
    tr, te = df.iloc[:120], df.iloc[120:].copy()
    te.loc[te.index[:3], "sex"] = "U"  # an unseen level encodes to zeros
    codec_t = TT.CovariateCodec(["age"], ["sex", "site"]).fit(tr)
    codec_j = JT.CovariateCodec(["age"], ["sex", "site"]).fit(tr)
    np.testing.assert_array_equal(codec_t.transform(te), codec_j.transform(te))
    assert codec_t.width == codec_j.width
    feats = FEATURES[:5]
    for got, want in zip(TT.residualize_features(tr, te, feats, ["age"], ["sex", "site"]),
                         JT.residualize_features(tr, te, feats, ["age"], ["sex", "site"])):
        np.testing.assert_allclose(got[feats].to_numpy(float), want[feats].to_numpy(float),
                                   rtol=0, atol=1e-12)
    te.loc[te.index[:2], "site"] = "Z"  # unseen site: global statistics
    for got, want in zip(TT.site_zscore(tr, te, feats, "site"),
                         JT.site_zscore(tr, te, feats, "site")):
        pd.testing.assert_frame_equal(got, want)


def test_roc_auc_rows_equals_per_row_roc_auc():
    rng = np.random.RandomState(3)
    scores = torch.tensor(np.round(rng.randn(7, 90) * 2), dtype=torch.float32)  # ties
    y = torch.tensor(rng.randint(0, 2, 90), dtype=torch.float32)
    got = roc_auc(y, scores)  # rows over the last axis, labels shared
    want = torch.stack([roc_auc(y, s) for s in scores])
    assert torch.equal(got, want)
    ys = torch.tensor(rng.randint(0, 2, (7, 90)), dtype=torch.float32)  # labels per row
    assert torch.equal(roc_auc(ys, scores),
                       torch.stack([roc_auc(a, s) for a, s in zip(ys, scores)]))
    w = torch.tensor(rng.rand(7, 90), dtype=torch.float32)  # weights per row
    assert torch.equal(roc_auc(ys, scores, w),
                       torch.stack([roc_auc(a, s, c) for a, s, c in zip(ys, scores, w)]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank_univariate_auc_equals_the_jax_package(seed):
    df = _frame(seed=seed)
    cols = FEATURES + ["text"]
    got = TT.rank_univariate_auc(df, df["label"].values, cols, top_k=20)
    want = JT.rank_univariate_auc(df, df["label"].values, cols, top_k=20)
    assert [c for c, _ in got] == [c for c, _ in want]
    np.testing.assert_allclose([a for _, a in got], [a for _, a in want], rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_permutation_screen_equals_the_jax_package(seed):
    rng = np.random.RandomState(seed)
    n, d = (60, 120, 200, 120)[seed], (3, 7, 12, 5)[seed]
    df = pd.DataFrame(rng.randn(n, d), columns=[f"f{j}" for j in range(d)])
    df["label"] = rng.randint(0, 2, n)
    cols = [f"f{j}" for j in range(d)]
    got = TT.permutation_screen(df, cols)
    want = JT.permutation_screen(df, cols)
    assert [r["repeat"] for r in got] == [r["repeat"] for r in want] == [1, 2, 3, 4, 5]
    np.testing.assert_allclose([r["roc_auc"] for r in got], [r["roc_auc"] for r in want],
                               rtol=0, atol=1e-5)


def test_permutation_screen_on_the_suites_frame_within_one_pair(baseline_df):  # noqa: F811
    """The meaningful suite's two screens on its test frame: every repeat
    within one held-out pair of the JAX function (see the module doc)."""
    from test_ppmi_suites import _load_script

    suite = _load_script("ppmi_meaningful_suite")
    settings = suite.resolve_settings(baseline_df)
    y_te = None
    for setting in ("full_clinical", "fusion_nonmotor_imaging"):
        got = TT.permutation_screen(baseline_df, settings[setting])
        want = JT.permutation_screen(baseline_df, settings[setting])
        y_te = TT.permutation_inputs(baseline_df, settings[setting], 5, 42)[4]
        pair = 1.0 / (y_te.sum(1) * (1 - y_te).sum(1))
        diff = np.abs(np.array([r["roc_auc"] for r in got]) - [r["roc_auc"] for r in want])
        assert (diff <= pair + 1e-6).all(), (setting, diff, pair)


def _sklearn_preprocessor(scale, num, cat):
    spec = importlib.util.spec_from_file_location(
        "jax_sweep", ROOT_DIR / "scripts" / "ppmi_train_tabular.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build_preprocessor(scale, num, cat, 1)


def _mixed(n, seed):
    r = np.random.RandomState(seed)
    df = pd.DataFrame({
        "a": r.randn(n) * 3 + 1, "b": r.randint(0, 5, n), "c": r.randn(n), "d": np.nan,
        "e": r.randn(n) * 1e-9 + 5.0, "g": r.rand(n) * 1e3,
        "cat": r.choice(["x", "y", "z"], n).astype(object),
        "cat2": r.choice(["p", "q"], n).astype(object),
    })
    df.loc[r.rand(n) < 0.2, "a"] = np.nan
    df.loc[r.rand(n) < 0.1, "g"] = np.nan
    df.loc[r.rand(n) < 0.1, "cat"] = np.nan
    return df


COLUMN_SETS = [
    (["a", "b", "c", "d", "e"], ["cat", "cat2"]), (["b", "c", "e"], []), (["c", "e", "g"], []),
    ([], ["cat", "cat2"]), (["b", "c"], ["cat"]), (["a", "g"], ["cat2"]), (["a"], []),
    (["d"], []), (["a", "d"], []),
]


@pytest.mark.parametrize("scale", [True, False], ids=["scaled", "unscaled"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sweep_transformer_equals_scikit_learn(scale, seed):
    tr, te = _mixed(101 + 50 * seed, seed), _mixed(37, seed + 100)
    te.loc[3, "cat"] = "unseen"
    tr["cat2"] = (["p", "q"] * 200)[: len(tr)]  # tied modes once a value is missing
    tr.loc[tr.index[-1], "cat2"] = np.nan
    for num, cat in COLUMN_SETS:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # scikit-learn warns on the all-NaN column
            ref = _sklearn_preprocessor(scale, num, cat)
            want = (ref.fit_transform(tr[num + cat]), ref.transform(te[num + cat]))
        mine = SuiteColumnTransformer(scale, num, cat)
        got = (mine.fit_transform(tr[num + cat]), mine.transform(te[num + cat]))
        for g, w in zip(got, want):
            assert g.shape == w.shape, (num, cat)
            np.testing.assert_array_equal(g, w, err_msg=f"{num} {cat}")
