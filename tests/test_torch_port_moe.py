"""The port's Mixture-of-Experts (``pd_fusion_torch/nn/moe.py``,
``models/moe.py``, the MoE scenario evaluation) against the JAX package's
on the same numpy inputs and the same initial weights (carried across by
``moe_params_from_jax``).

Tolerances: the forward to 1e-6. Training draws nothing at random, so
from the JAX init the port follows the JAX run: after 50 full-batch Adam
steps, single-model params within 1e-4 (measured 1.1e-5); the fold-batched
trainer within 5e-3 on the params and 1e-3 on the probabilities (Adam
turns a rounding difference in a near-zero gradient into a step of up to
``lr``: measured 2.3e-3 on one weight of one fold, and 5.1e-4 on that
fold's probabilities; the other folds stay within 1e-5). Scenario metrics
to 1e-5.
"""
import jax
import numpy as np
import pytest
import torch

from pd_fusion.nn import moe as JM
from pd_fusion.parallel import cv_engine as JC
from pd_fusion_torch.nn import moe as TM
from test_torch_port_jax_draws import one_cpu_thread

DIMS = {"clinical": 4, "datspect": 2, "mri": 6}


@pytest.fixture(autouse=True)
def _one_thread():
    with one_cpu_thread():
        yield


def _jax_params(key, dims=DIMS, eh=(8, 4), rh=(6,)):
    return jax.tree_util.tree_map(np.asarray, JM.moe_init(jax.random.PRNGKey(key), dims,
                                                           list(eh), list(rh)))


def _inputs(n=60, seed=1, dims=DIMS):
    rng = np.random.RandomState(seed)
    mods = sorted(dims)
    f_max = max(dims.values())
    x = np.zeros((len(mods), n, f_max), np.float32)
    for mi, m in enumerate(mods):
        x[mi, :, : dims[m]] = rng.randn(n, dims[m])
    mask = rng.randint(0, 2, (n, len(mods))).astype(np.float32)
    y = rng.randint(0, 2, n).astype(np.float32)
    return x, mask, y


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _max_param_err(a, b):
    return max(float(np.abs(np.asarray(a[part][i][k]) - np.asarray(b[part][i][k])).max())
               for part in ("experts", "router") for i in range(len(a[part])) for k in ("w", "b"))


def test_moe_apply_matches_jax_single_and_fold_batched():
    p = _jax_params(0)
    x, mask, _ = _inputs()
    want = np.asarray(JM.moe_apply(p, x, mask))
    got = TM.moe_apply(TM.moe_params_from_jax(p), *_t(x, mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)

    # a [K] stack applied to [K, S, ...] inputs through [K, 1] params
    K, S = 3, 2
    ps = [_jax_params(k) for k in range(K)]
    stacked = jax.tree_util.tree_map(lambda *a: np.stack(a), *ps)
    xs = np.stack([np.stack([_inputs(seed=10 * k + s)[0] for s in range(S)]) for k in range(K)])
    ms = np.stack([np.stack([_inputs(seed=10 * k + s)[1] for s in range(S)]) for k in range(K)])
    tp = TM.map_params(TM.moe_params_from_jax(stacked), lambda v: v[:, None])
    got = TM.moe_apply(tp, *_t(xs, ms)).numpy()
    for k in range(K):
        for s in range(S):
            np.testing.assert_allclose(got[k, s], np.asarray(JM.moe_apply(ps[k], xs[k, s], ms[k, s])),
                                       atol=1e-6, rtol=0)


def test_params_from_jax_copy_and_round_trip():
    p = _jax_params(0)
    tp = TM.moe_params_from_jax(p)
    tp["experts"][0]["w"] += 1.0
    assert not np.allclose(p["experts"][0]["w"], tp["experts"][0]["w"].numpy())
    back = TM.moe_params_to_numpy(TM.moe_params_from_jax(p))
    assert _max_param_err(back, p) == 0.0


@pytest.mark.parametrize("weight_decay", [0.0, 1e-3])
def test_train_moe_follows_the_jax_run_from_its_init(weight_decay):
    p = _jax_params(0)
    x, mask, y = _inputs()
    want = jax.tree_util.tree_map(np.asarray, JM.train_moe(p, x, mask, y, 0.01, 50, weight_decay))
    got = TM.moe_params_to_numpy(TM.train_moe(TM.moe_params_from_jax(p), *_t(x, mask, y), 0.01,
                                              50, weight_decay))
    assert _max_param_err(got, want) < 1e-4


def test_fold_batched_trainer_follows_the_jax_vmapped_trainer():
    """``train_moe_folds`` against ``cv_engine._train_folds_moe``: weighted
    BCE with the safe denominator, a ragged fold (weight-0 rows), 50
    epochs from the JAX init."""
    K = 3
    ps = jax.tree_util.tree_map(lambda *a: np.stack(a), *[_jax_params(k) for k in range(K)])
    x, mask, y = _inputs()
    xs, ms, ys = (np.stack([a] * K) for a in (x, mask, y))
    ws = np.ones((K, len(y)), np.float32)
    ws[2, -10:] = 0.0
    want = jax.tree_util.tree_map(np.asarray, JC._train_folds_moe(ps, xs, ms, ys, ws, 0.01, 50, 0.0))
    got = TM.train_moe_folds(TM.moe_params_from_jax(ps), *_t(xs, ms, ys, ws), 0.01, 50)
    assert _max_param_err(TM.moe_params_to_numpy(got), want) < 5e-3
    p_want = np.stack([np.asarray(JM.moe_apply(jax.tree_util.tree_map(lambda v: v[k], want),
                                               xs[k], ms[k])) for k in range(K)])
    p_got = TM.moe_apply(got, *_t(xs, ms)).numpy()
    np.testing.assert_allclose(p_got, p_want, atol=1e-3, rtol=0)
    # and each fold of the stack equals that fold trained alone
    for k in range(K):
        one = TM.train_moe_folds(TM.map_params(TM.moe_params_from_jax(ps), lambda v: v[k:k + 1]),
                                 *_t(xs[k:k + 1], ms[k:k + 1], ys[k:k + 1], ws[k:k + 1]), 0.01, 50)
        assert _max_param_err(TM.moe_params_to_numpy(TM.map_params(got, lambda v: v[k:k + 1])),
                              TM.moe_params_to_numpy(one)) < 1e-5


def test_moe_init_uses_true_fan_in_and_zeroes_padded_rows():
    p = TM.moe_init(torch.Generator().manual_seed(0), DIMS, [8, 4], [6])
    mods = sorted(DIMS)
    w0 = p["experts"][0]["w"]
    assert tuple(w0.shape) == (3, 6, 8)
    for mi, m in enumerate(mods):
        assert torch.all(w0[mi, DIMS[m]:] == 0)
        bound = 1.0 / np.sqrt(DIMS[m])
        assert float(w0[mi, : DIMS[m]].abs().max()) <= bound
    assert [tuple(l["w"].shape) for l in p["router"]] == [(3, 6), (6, 3)]


def test_stacked_moe_equals_serial_experts():
    rng = np.random.RandomState(1)
    mods = sorted(DIMS)
    n = 30
    params = TM.moe_init(torch.Generator().manual_seed(0), DIMS, [8, 4], [6])
    X = {m: rng.randn(n, DIMS[m]).astype(np.float32) for m in mods}
    mask = rng.randint(0, 2, (n, 3)).astype(np.float32)
    x_stack = np.zeros((3, n, max(DIMS.values())), np.float32)
    for mi, m in enumerate(mods):
        x_stack[mi, :, : DIMS[m]] = X[m]
    combined = TM.moe_apply(params, *_t(x_stack, mask)).numpy()
    npp = TM.moe_params_to_numpy(params)

    def serial_expert(mi, x):
        h = x
        for li, layer in enumerate(npp["experts"]):
            w = layer["w"][mi]
            if li == 0:
                w = w[: x.shape[1]]
            h = h @ w + layer["b"][mi]
            if li < len(npp["experts"]) - 1:
                h = np.maximum(h, 0)
        return 1.0 / (1.0 + np.exp(-h[:, 0]))

    r = mask
    for li, layer in enumerate(npp["router"]):
        r = r @ layer["w"] + layer["b"]
        if li < len(npp["router"]) - 1:
            r = np.maximum(r, 0)
    r = np.exp(r - r.max(axis=1, keepdims=True))
    weights = r / r.sum(axis=1, keepdims=True)
    expect = sum(weights[:, mi] * serial_expert(mi, X[m]) for mi, m in enumerate(mods))
    np.testing.assert_allclose(combined, expect, atol=1e-5)


def test_moe_router_uses_mask(tmp_path, monkeypatch):
    from pd_fusion_torch.models.moe import MoEModel
    from pd_fusion_torch.utils.metrics import compute_metrics
    from pd_fusion_torch.utils.seed import set_seed

    monkeypatch.setenv("PD_FUSION_TORCH_DEVICE", "cpu")
    set_seed(0)
    n = 300
    rng = np.random.RandomState(2)
    y = rng.randint(0, 2, n)
    X_dict = {"clinical": (rng.randn(n, 4) + y[:, None] * 1.5).astype(np.float32),
              "datspect": (rng.randn(n, 3) + y[:, None] * 1.5).astype(np.float32)}
    mask = np.ones((n, 2), np.float32)
    m = MoEModel({"clinical": 4, "datspect": 3},
                 {"expert_hidden_dims": [16, 8], "router_hidden_dims": [8], "lr": 0.01,
                  "epochs": 200})
    m.train(X_dict, y, mask)
    p = m.predict_proba(X_dict, mask)
    assert compute_metrics(y, p)["roc_auc"] > 0.85
    m.save(tmp_path / "moe.pt")
    m2 = MoEModel.load(tmp_path / "moe.pt")
    np.testing.assert_allclose(p, m2.predict_proba(X_dict, mask), atol=1e-6)
    np.testing.assert_allclose(m.predict_proba(X_dict), m.predict_proba(X_dict, mask), atol=0)


def test_moe_model_saved_by_the_port_loads_through_serialization(tmp_path, monkeypatch):
    from pd_fusion_torch.models.moe import MoEModel
    from pd_fusion_torch.models.serialization import load_model

    monkeypatch.setenv("PD_FUSION_TORCH_DEVICE", "cpu")
    m = MoEModel(DIMS, {"expert_hidden_dims": [8], "router_hidden_dims": [4], "lr": 0.01,
                        "epochs": 3})
    x, mask, y = _inputs()
    X_dict = {mod: x[mi, :, : DIMS[mod]] for mi, mod in enumerate(sorted(DIMS))}
    m.train(X_dict, y, mask)
    m.save(tmp_path / "model.pt")
    again = load_model(tmp_path / "model.pt")
    assert isinstance(again, MoEModel)
    np.testing.assert_array_equal(again.predict_proba(X_dict, mask), m.predict_proba(X_dict, mask))


def _scenario_frame():
    from pd_fusion_torch.data.ppmi_loader import generate_synthetic_data
    from pd_fusion_torch.utils.seed import set_seed

    set_seed(3)
    return generate_synthetic_data({"num_samples": 120, "clinical_dim": 6, "datspect_dim": 4,
                                    "mri_dim": 8, "missing_rates": [0.1, 0.2, 0.3]})


SCENARIOS = [{"name": "full_observation", "drop_modalities": []},
             {"name": "drop_mri", "drop_modalities": ["mri"]},
             {"name": "random_1", "random_drop": 1}]


def test_fused_scenario_eval_matches_the_loop_and_the_jax_package(monkeypatch):
    """The port's one-forward MoE scenario evaluation against its own
    per-scenario loop and against the JAX package's fused evaluation of
    the same trained weights (same scenario draws)."""
    from pd_fusion.evaluation import evaluate as JE
    from pd_fusion.models.moe import MoEModel as JMoE
    from pd_fusion.utils.seed import set_seed as jax_set_seed
    from pd_fusion_torch.data.feature_utils import get_modality_feature_cols
    from pd_fusion_torch.data.missingness import apply_missingness_scenario
    from pd_fusion_torch.data.preprocess import preprocess_features
    from pd_fusion_torch.data.schema import TARGET_COL
    from pd_fusion_torch.evaluation import evaluate as TE
    from pd_fusion_torch.models.moe import MoEModel
    from pd_fusion_torch.utils.metrics import compute_metrics
    from pd_fusion_torch.utils.seed import set_seed

    monkeypatch.setenv("PD_FUSION_TORCH_DEVICE", "cpu")
    df, masks = _scenario_frame()
    mod_dims = {"clinical": 6, "datspect": 4, "mri": 8}
    prep_info, X_dict = {}, {}
    for mod in mod_dims:
        feats = get_modality_feature_cols(df, mod)
        X, _, scaler = preprocess_features(df, feats)
        prep_info[mod] = (None, scaler, feats)
        X_dict[mod] = X
    y = df[TARGET_COL].values
    mask_mat = np.stack([masks[m] for m in mod_dims], axis=1).astype(np.float32)
    params = {"expert_hidden_dims": [8], "router_hidden_dims": [4], "lr": 0.01, "epochs": 10}
    jmodel = JMoE(mod_dims, params)
    jmodel.train(X_dict, y, mask_mat)
    model = MoEModel(mod_dims, params)
    model.net_params = TM.moe_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                     jmodel.net_params))

    set_seed(11)
    fused = TE.evaluate_model(model, df, masks, prep_info, {"scenarios": SCENARIOS})
    set_seed(11)
    loop = {}
    for scenario in SCENARIOS:
        cm = apply_missingness_scenario(df, scenario, masks)
        loop[scenario["name"]] = compute_metrics(y, TE.predict_for_masks(model, df, cm, prep_info))
    jax_set_seed(11)
    want = JE.evaluate_model(jmodel, df, masks, prep_info, {"scenarios": SCENARIOS})
    assert set(fused) == set(loop) == set(want)
    for scen in fused:
        for metric, v in loop[scen].items():
            assert fused[scen][metric] == pytest.approx(v, abs=1e-5), (scen, metric)
            assert fused[scen][metric] == pytest.approx(want[scen][metric], abs=1e-5)
