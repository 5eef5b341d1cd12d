"""The port's histogram GBDT and TreeSHAP (``pd_fusion_torch/nn/gbdt.py``,
``ops/treeshap.py``, ``models/unimodal_gbdt.py``) against the JAX
package's on the same numpy inputs.

Tolerances and what is held exact:
- bin edges, bin codes and the base score: bit for bit;
- float64 training: the split structure (feature, threshold, missing
  direction) equals the JAX package's ``train_gbdt`` for both histogram
  lowerings, leaf values and gains to 1e-9, and every ensemble passes the
  split-optimality audit (``nn/gbdt_checks.py``, a copy of
  ``tests/test_device_gbdt.py``'s). Seed 0 is the exception the audit
  exists for: at round 2 two features tie exactly (gain 1.16208142) and
  the JAX package's cumulative sums (an associative scan on the CPU) and
  torch's (sequential) break the tie apart; both ensembles pass the audit;
- the two lowerings' histograms to 1e-12 in float64;
- TreeSHAP: the JAX package's values to 1e-5 on the same trees,
  brute-force Shapley values to 2e-5, additivity to 5e-4 (float32).
"""
from itertools import combinations
from math import factorial

import numpy as np
import pytest
import torch

from pd_fusion.nn import gbdt as JG
from pd_fusion_torch.nn import gbdt as TG
from pd_fusion_torch.nn import gbdt_checks as checks
from pd_fusion_torch.ops import treeshap as TS
from test_torch_port_jax_draws import one_cpu_thread

HP8 = dict(n_rounds=8, depth=3, lr=0.3, lam=0.5, min_child_weight=1e-3, min_child_samples=5.0)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("PD_FUSION_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("PD_FUSION_GBDT_BACKEND", raising=False)
    monkeypatch.delenv("PD_FUSION_GBDT_HIST", raising=False)
    with one_cpu_thread():
        yield


def _jax_train_f64(bins, y, w, base, hp):
    import jax.numpy as jnp
    from jax import enable_x64

    with enable_x64():
        trees = JG.train_gbdt(jnp.asarray(bins), jnp.asarray(y, jnp.float64),
                              jnp.asarray(w, jnp.float64), jnp.float64(base), **hp)
        return {k: np.asarray(v) for k, v in trees.items()}


def _port_train(bins, y, w, base, hp, dtype=torch.float64):
    return checks.to_numpy(TG.train_gbdt(torch.from_numpy(bins), torch.tensor(y, dtype=dtype),
                                         torch.tensor(w, dtype=dtype), base, **hp))


def _binned(seed, **kw):
    X, y = checks.make_data(seed, **kw)
    return X, y, TG.bin_features(X, TG.fit_bin_edges(X))


# --------------------------------------------------------------------------
# host binning and the base score
# --------------------------------------------------------------------------


def test_bins_and_base_score_bit_for_bit():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 5)).astype(np.float32)
    X[:, 1] = np.round(X[:, 1])  # few distinct values
    X[:, 2] = 3.0  # constant
    X[:, 3] = np.nan  # nothing finite
    X[rng.random((300, 5)) < 0.1] = np.inf
    je, te = JG.fit_bin_edges(X), TG.fit_bin_edges(X)
    assert len(je) == len(te) and all(np.array_equal(a, b) for a, b in zip(je, te))
    assert all(a.dtype == b.dtype for a, b in zip(je, te))
    Xq = rng.normal(size=(50, 5)).astype(np.float32)
    np.testing.assert_array_equal(TG.bin_features(Xq, te), JG.bin_features(Xq, je))
    y = (rng.random(300) < 0.3).astype(np.float32)
    w = rng.random(300).astype(np.float32)
    for args in ((y,), (y, w), (np.zeros(4, np.float32),), (np.ones(3, np.float32),),
                 (y, np.zeros(300, np.float32))):
        assert TG.compute_base_score(*args) == JG.compute_base_score(*args)


# --------------------------------------------------------------------------
# training against the JAX package, float64
# --------------------------------------------------------------------------


@pytest.mark.parametrize("hist_mode", ["scatter", "onehot"])
@pytest.mark.parametrize("seed", [1, 3, 7, 0])
def test_float64_trees_equal_the_jax_package_and_pass_the_audit(seed, hist_mode):
    X, y, bins = _binned(seed)
    w = np.ones_like(y, np.float64)
    hp = dict(HP8, hist_mode=hist_mode)
    want = _jax_train_f64(bins, y, w, 0.125, hp)
    got = _port_train(bins, y, w, 0.125, hp)
    if seed != 0:
        assert checks.same_structure(got, want)
        np.testing.assert_allclose(got["leaf"], want["leaf"], atol=1e-9, rtol=0)
        np.testing.assert_allclose(got["gain"], want["gain"], atol=1e-9, rtol=0)
        np.testing.assert_allclose(got["leaf_cover"], want["leaf_cover"], atol=1e-9, rtol=0)
    else:  # an exact tie at round 2, broken apart by cumsum order
        assert not checks.same_structure(got, want)
    audit = dict(n_rounds=8, depth=3, lr=0.3, lam=0.5, mcw=1e-3, mcs=5.0, base=0.125)
    margin = checks.audit_trees(bins, y, w, got, **audit)
    checks.audit_trees(bins, y, w, want, **audit)
    dev_margin = TG.predict_margin({k: torch.from_numpy(v) for k, v in got.items()},
                                   torch.from_numpy(bins), 0.125, depth=3).numpy()
    np.testing.assert_allclose(dev_margin, margin, atol=1e-9)


def test_audit_catches_a_wrong_leaf_and_a_wrong_split():
    X, y, bins = _binned(1)
    w = np.ones_like(y, np.float64)
    trees = _port_train(bins, y, w, 0.125, dict(HP8, hist_mode="scatter"))
    audit = dict(n_rounds=8, depth=3, lr=0.3, lam=0.5, mcw=1e-3, mcs=5.0, base=0.125)
    bad = {k: v.copy() for k, v in trees.items()}
    bad["leaf"][3, 2] += 1e-6
    with pytest.raises(AssertionError, match="leaf"):
        checks.audit_trees(bins, y, w, bad, **audit)
    bad = {k: v.copy() for k, v in trees.items()}
    bad["thr"][0, 0, 0] = max(0, bad["thr"][0, 0, 0] - 7)
    with pytest.raises(AssertionError, match="gain"):
        checks.audit_trees(bins, y, w, bad, **audit)


def test_float32_fit_passes_the_audit_and_predicts_like_the_jax_package():
    import jax.numpy as jnp

    X, y, bins = _binned(4, n=240, f=5)
    w = np.ones_like(y)
    hp = dict(n_rounds=6, depth=4, lr=0.2, lam=0.0, min_child_weight=1e-3,
              min_child_samples=10.0, hist_mode="scatter")
    base = np.float32(TG.compute_base_score(y))
    got = _port_train(bins, y, w, base, hp, dtype=torch.float32)
    checks.audit_trees(bins, y, w, got, 6, 4, 0.2, 0.0, 1e-3, 10.0, float(base),
                       **checks.F32_TOLS)
    want = JG.predict_margin({k: jnp.asarray(v) for k, v in got.items()}, jnp.asarray(bins),
                             jnp.float32(base), depth=4)
    mine = TG.predict_margin({k: torch.from_numpy(v) for k, v in got.items()},
                             torch.from_numpy(bins), base, depth=4)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(want))


def test_histogram_lowerings_agree_in_float64():
    rng = np.random.default_rng(13)
    n, f, L = 257, 5, 8
    bins = rng.integers(0, 256, size=(n, f)).astype(np.int64)
    bins[rng.random((n, f)) < 0.1] = TG.MISSING_BIN
    data = torch.from_numpy(rng.normal(size=(1, n, 3)))
    node = torch.from_numpy(rng.integers(0, L, size=(1, n)))
    b = torch.from_numpy(bins)[None]
    h1, t1 = TG._histograms(b, data, node, L, "scatter")
    h2, t2 = TG._histograms(b, data, node, L, "onehot")
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), atol=1e-12)
    np.testing.assert_allclose(t1.numpy(), t2.numpy(), atol=1e-12)
    sel = node[0].numpy() == 3
    expect = np.bincount(bins[sel, 2], weights=data[0, sel, 0].numpy(), minlength=256)
    np.testing.assert_allclose(h1[0, 3, 2, :, 0].numpy(), expect, atol=1e-12)


@pytest.mark.parametrize("hist_mode", ["scatter", "onehot"])
def test_fold_batched_fit_equals_per_fold_fits(hist_mode):
    """The same splits and leaves; a recorded gain may differ by an ulp on
    the CPU, whose vectorised sigmoid rounds a row's tail elements
    differently when the row stands alone."""
    bins, y, w, base = checks.cv_like_inputs(K=3, n=120, f=4)
    hp = dict(n_rounds=5, depth=3, lr=0.3, lam=0.0, min_child_weight=1e-3,
              min_child_samples=5.0, hist_mode=hist_mode)
    stacked = checks.fit(bins, y, w, base, hp, "cpu")
    for k in range(3):
        one = checks.fit(bins[k], y[k], w[k], base[k], hp, "cpu")
        mine = {key: v[k] for key, v in stacked.items()}
        assert checks.same_structure(mine, one)
        np.testing.assert_array_equal(mine["leaf"], one["leaf"])
        np.testing.assert_allclose(mine["gain"], one["gain"], rtol=1e-6, atol=0)


def test_zero_weight_rows_are_invisible():
    X, y = checks.make_data(seed=4, n=200, f=4)
    a = TG.DeviceHistGBDT(n_estimators=6, max_depth=3).fit(X, y)
    bins = TG.bin_features(X, a.edges_)
    pad = TG.bin_features(np.full((50, 4), 7.7, np.float32), a.edges_)
    yn = np.concatenate([y, np.ones(50, np.float32)])
    w = np.concatenate([np.ones_like(y), np.zeros(50, np.float32)])
    hp = dict(n_rounds=6, depth=3, lr=0.1, lam=0.0, min_child_weight=1e-3, min_child_samples=20.0)
    ta = _port_train(bins, y, np.ones_like(y), np.float32(a.base_score_), hp, torch.float32)
    tb = _port_train(np.concatenate([bins, pad]), yn, w, np.float32(a.base_score_), hp,
                     torch.float32)
    assert checks.same_structure(ta, tb)
    np.testing.assert_allclose(ta["leaf"], tb["leaf"], atol=1e-5)


def test_weighted_equals_repetition():
    """Integer weights equal repeated rows (the trainer is weight-linear),
    with the binning held fixed."""
    X, y = checks.make_data(seed=2, n=120, f=4, miss=0.1)
    w = np.random.default_rng(5).integers(1, 4, size=len(y)).astype(np.float32)
    edges = TG.fit_bin_edges(X)
    bins = TG.bin_features(X, edges)
    reps = w.astype(int)
    hp = dict(n_rounds=6, depth=3, lr=0.3, lam=0.0, min_child_weight=1e-3, min_child_samples=20.0,
              hist_mode="scatter")
    base = TG.compute_base_score(y, w)
    tw = _port_train(bins, y, w.astype(np.float64), base, hp)
    tr = _port_train(np.repeat(bins, reps, axis=0), np.repeat(y, reps),
                     np.ones(reps.sum()), base, hp)
    assert checks.same_structure(tw, tr)
    np.testing.assert_allclose(tw["leaf"], tr["leaf"], atol=1e-12)


def test_missing_direction_is_learned():
    from pd_fusion_torch.utils.metrics import compute_metrics

    rng = np.random.default_rng(3)
    X = rng.normal(size=(400, 2)).astype(np.float32)
    y = (rng.random(400) < 0.5).astype(np.float32)
    X[y == 1, 0] = np.nan  # feature 0 missing iff positive
    m = TG.DeviceHistGBDT(n_estimators=5, learning_rate=0.5, max_depth=2).fit(X, y)
    assert compute_metrics(y, m.predict_proba(X)[:, 1])["roc_auc"] > 0.99


def test_constant_features_yield_prevalence():
    X = np.full((100, 3), 2.5, np.float32)
    y = np.array([0.0, 1.0] * 50, np.float32)
    m = TG.DeviceHistGBDT(n_estimators=5, max_depth=3).fit(X, y)
    p = m.predict_proba(X)[:, 1]
    assert np.all(np.isfinite(p))
    np.testing.assert_allclose(p, 0.5, atol=1e-5)
    np.testing.assert_array_equal(m.feature_importances_, np.zeros(3))


def test_single_class_labels_no_nan():
    X, y = checks.make_data(seed=15, n=80, f=4)
    p = TG.DeviceHistGBDT(n_estimators=5, max_depth=2).fit(X, np.ones_like(y)).predict_proba(X)
    assert np.all(np.isfinite(p[:, 1])) and np.all(p[:, 1] > 0.9)


def test_class_weight_balanced_equals_manual_weights():
    X, _ = checks.make_data(seed=17, n=200, f=4)
    y = (np.arange(200) % 4 == 0).astype(np.float32)
    a = TG.DeviceHistGBDT(n_estimators=8, max_depth=3, class_weight="balanced").fit(X, y)
    cw = 200 / (2.0 * np.bincount(y.astype(int), minlength=2))
    b = TG.DeviceHistGBDT(n_estimators=8, max_depth=3).fit(
        X, y, sample_weight=cw[y.astype(int)].astype(np.float32))
    np.testing.assert_array_equal(a.predict_proba(X), b.predict_proba(X))
    with pytest.raises(ValueError, match="class_weight"):
        TG.DeviceHistGBDT(class_weight="bogus")


def test_device_fit_matches_the_jax_device_fit():
    """``DeviceHistGBDT`` end to end (binning, base score, float32 trees,
    predictions) against the JAX package's class on the same data."""
    X, y = checks.make_data(seed=5, n=200, f=4)
    a = TG.DeviceHistGBDT(n_estimators=10, learning_rate=0.2, max_depth=3).fit(X, y)
    b = JG.DeviceHistGBDT(n_estimators=10, learning_rate=0.2, max_depth=3).fit(X, y)
    assert a.base_score_ == b.base_score_
    assert checks.same_structure(a.trees_, b.trees_)
    np.testing.assert_allclose(a.predict_proba(X), b.predict_proba(X), atol=1e-6)
    np.testing.assert_allclose(a.feature_importances_, b.feature_importances_, atol=1e-6)


def test_unfitted_and_pre_gain_artifacts_are_hasattr_safe():
    m = TG.DeviceHistGBDT()
    assert not hasattr(m, "feature_importances_")
    assert issubclass(TG.NotFittedError, ValueError)
    X, y = checks.make_data(seed=18, n=100, f=4)
    m.fit(X, y)
    del m.trees_["gain"]
    assert not hasattr(m, "feature_importances_")
    assert np.isfinite(m.predict_proba(X)).all()


def test_backend_and_hist_mode_resolution(monkeypatch, caplog):
    import logging

    assert TG.resolve_gbdt_backend(None) == "host"  # the CPU asked for
    assert TG.resolve_gbdt_backend("auto") == "host"
    assert TG.resolve_gbdt_backend("device") == "device"
    assert TG.resolve_gbdt_backend("lightgbm") == "host"
    with pytest.raises(ValueError, match="backend"):
        TG.resolve_gbdt_backend("cuda")
    monkeypatch.setenv("PD_FUSION_GBDT_BACKEND", "host")
    assert TG.resolve_gbdt_backend("device") == "host"
    monkeypatch.setenv("PD_FUSION_GBDT_BACKEND", "device")
    assert TG.resolve_gbdt_backend("host") == "device"
    monkeypatch.delenv("PD_FUSION_GBDT_BACKEND")
    monkeypatch.setenv("PD_FUSION_TORCH_DEVICE", "cuda")  # the card's default
    assert TG.resolve_gbdt_backend(None) == "device"
    assert TG.resolve_hist_mode("auto") == "onehot"
    monkeypatch.setenv("PD_FUSION_TORCH_DEVICE", "cpu")
    assert TG.DeviceHistGBDT().hist_mode == "auto"
    for alias in (None, "", "auto"):
        assert TG.resolve_hist_mode(alias) == "scatter"
    assert TG.resolve_hist_mode("onehot") == "onehot"
    with pytest.raises(ValueError, match="hist_mode"):
        TG.resolve_hist_mode("one_hot")
    with pytest.raises(ValueError, match="hist_mode"):
        TG.DeviceHistGBDT(hist_mode="one_hot")
    monkeypatch.setenv("PD_FUSION_GBDT_HIST", "onehot")
    assert TG.DeviceHistGBDT().hist_mode == "onehot"
    with caplog.at_level(logging.WARNING, logger="pd_fusion"):
        assert TG.DeviceHistGBDT(max_depth=12).max_depth == 10
    assert any("clamped" in r.message for r in caplog.records)


def test_trees_from_jax_predict_like_the_jax_package():
    import jax.numpy as jnp

    X, y, bins = _binned(6, n=150, f=4)
    jt = JG.train_gbdt(jnp.asarray(bins), jnp.asarray(y), jnp.ones(len(y)), jnp.float32(0.1),
                       n_rounds=5, depth=3, lr=0.3, lam=0.0, min_child_weight=1e-3,
                       min_child_samples=5.0)
    want = JG.predict_margin(jt, jnp.asarray(bins), jnp.float32(0.1), depth=3)
    got = TG.predict_margin(TG.gbdt_trees_from_jax(jt), torch.from_numpy(bins), np.float32(0.1),
                            depth=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# UnimodalGBDT
# --------------------------------------------------------------------------


def test_unimodal_gbdt_device_backend_round_trip(tmp_path):
    from pd_fusion_torch.models.serialization import load_model
    from pd_fusion_torch.models.unimodal_gbdt import UnimodalGBDT

    X, y = checks.make_data(seed=6, n=200, f=4)
    m = UnimodalGBDT("clinical", {"backend": "device", "n_estimators": 10, "max_depth": 3})
    assert m.backend == "device"
    m.train(X, y)
    p = m.predict_proba(X)
    assert p.shape == (200,) and np.all((p >= 0) & (p <= 1))
    m.save(tmp_path / "gbdt.pkl")
    again = load_model(tmp_path / "gbdt.pkl")
    np.testing.assert_array_equal(again.predict_proba(X), p)
    np.testing.assert_array_equal(m.prepare_eval_bins(X), TG.bin_features(X, m.model.edges_))


def test_unimodal_gbdt_host_backend_and_its_missing_scikit_learn(monkeypatch):
    import sys

    from pd_fusion_torch.models.unimodal_gbdt import UnimodalGBDT

    X, y = checks.make_data(seed=3, n=200, f=5, miss=0.0)
    m = UnimodalGBDT("clinical", {"n_estimators": 20, "max_depth": 3, "random_state": 0})
    assert m.backend == "histgb"  # auto on the CPU
    m.train(X, y)
    assert m.predict_proba(X).shape == (200,)
    monkeypatch.setitem(sys.modules, "sklearn.ensemble", None)
    with pytest.raises(ImportError, match="scikit-learn"):
        UnimodalGBDT("clinical", {"backend": "host"})
    assert UnimodalGBDT("clinical", {"backend": "device"}).backend == "device"


# --------------------------------------------------------------------------
# TreeSHAP
# --------------------------------------------------------------------------


def _v_of_S(tree, x_bins, S, depth):
    """Path-dependent game value of coalition S on one tree (numpy)."""
    def child_cover(level, node):
        span = 1 << (depth - level)
        return float(tree["leaf_cover"][node * span: (node + 1) * span].sum())

    def walk(level, node):
        if level == depth:
            return float(tree["leaf"][node])
        f = int(tree["feat"][level, node])
        if f in S:
            b = x_bins[f]
            left = bool(tree["miss_left"][level, node]) if b == TG.MISSING_BIN else (
                b <= tree["thr"][level, node])
            return walk(level + 1, node * 2 + (0 if left else 1))
        pc = child_cover(level, node)
        if pc <= 0:
            return 0.0
        return (child_cover(level + 1, node * 2) * walk(level + 1, node * 2)
                + child_cover(level + 1, node * 2 + 1) * walk(level + 1, node * 2 + 1)) / pc

    return walk(0, 0)


def _brute_shap(model, X):
    bins = TG.bin_features(np.asarray(X, np.float32), model.edges_)
    n, F = bins.shape
    D = model.max_depth
    trees = [{k: v[r] for k, v in model.trees_.items()}
             for r in range(model.trees_["feat"].shape[0])]
    phi = np.zeros((n, F))
    ev = model.base_score_ + sum(_v_of_S(t, bins[0], set(), D) for t in trees)
    for i in range(F):
        rest = [j for j in range(F) if j != i]
        for k in range(F):
            w = factorial(k) * factorial(F - k - 1) / factorial(F)
            for S in map(set, combinations(rest, k)):
                for ni in range(n):
                    for t in trees:
                        phi[ni, i] += w * (_v_of_S(t, bins[ni], S | {i}, D)
                                           - _v_of_S(t, bins[ni], S, D))
    return phi, ev


def _shap_data(seed, n=48, f=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    X[rng.random((n, f)) < 0.15] = np.nan
    logits = np.nan_to_num(X[:, 0]) - 0.7 * np.nan_to_num(X[:, 1])
    y = (rng.random(n) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    return X, y


@pytest.mark.parametrize("seed,class_weight", [(0, None), (1, "balanced")])
def test_shap_matches_bruteforce_shapley(seed, class_weight):
    X, y = _shap_data(seed)
    m = TG.DeviceHistGBDT(n_estimators=4, max_depth=3, learning_rate=0.3,
                          class_weight=class_weight).fit(X, y)
    phi = m.shap_values(X[:6])
    ref, ev_ref = _brute_shap(m, X[:6])
    np.testing.assert_allclose(phi, ref, atol=2e-5)
    assert m.expected_value_ == pytest.approx(ev_ref, abs=2e-5)


def test_shap_matches_the_jax_package_and_is_additive():
    from pd_fusion.ops import treeshap as JT

    X, y = _shap_data(3, n=200, f=8)
    X[:, 7] = 1.0  # constant: never split on -> zero attribution
    m = TG.DeviceHistGBDT(n_estimators=30, max_depth=5, learning_rate=0.1).fit(X, y)
    Xq = np.concatenate([X[:50], np.random.default_rng(7).normal(size=(10, 8)).astype(np.float32)])
    phi = m.shap_values(Xq)
    margin = m._margin(Xq)
    np.testing.assert_allclose(phi.sum(axis=1) + m.expected_value_, margin, atol=5e-4)
    assert np.abs(phi[:, 7]).max() == 0.0
    import jax.numpy as jnp

    bins = TG.bin_features(Xq, m.edges_)
    want, ev = JT.shap_values({k: jnp.asarray(v) for k, v in m.trees_.items()}, bins,
                              m.base_score_, depth=5)
    np.testing.assert_allclose(phi, np.asarray(want), atol=1e-5)
    assert m.expected_value_ == pytest.approx(ev, abs=1e-5)


def test_shap_chunking_depth_gate_and_empty_input(monkeypatch):
    X, y = _shap_data(5, n=300, f=6)
    m = TG.DeviceHistGBDT(n_estimators=6, max_depth=4).fit(X, y)
    full = m.shap_values(X)  # crosses the 256-row chunk boundary
    monkeypatch.setattr(TS, "_CHUNK", 64)
    np.testing.assert_allclose(m.shap_values(X), full, atol=1e-6)
    ev = m.expected_value_
    empty = m.shap_values(X[:0])
    assert empty.shape == (0, 6) and empty.dtype == np.float32
    assert m.expected_value_ == pytest.approx(ev, abs=1e-6)
    deep = TG.DeviceHistGBDT(n_estimators=2, max_depth=9).fit(X[:64], y[:64])
    with pytest.raises(ValueError, match="depth"):
        deep.shap_values(X[:4])
