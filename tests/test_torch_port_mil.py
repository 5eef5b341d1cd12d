"""The port's MIL head and trainer (pd_fusion_torch/nn/mil.py,
models/mil_attention.py) against the JAX package's (pd_fusion/nn/mil.py),
with weights carried across and, for training, the JAX package's own
random draws fed through the explicit-draws seam. Tolerances: forward
1e-5 absolute; trained params 1e-5 absolute + 1e-4 relative (a few Adam
steps over f32 sums taken in another order)."""
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pd_fusion.nn import mil as J
from pd_fusion_torch.nn import mil as T
from test_torch_port_jax_draws import one_cpu_thread

D, L, H, A = 16, 14, 16, 8


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("PD_FUSION_TORCH_DEVICE", "cpu")
    with one_cpu_thread():
        yield


def _bags(n, seed, signal=2.5):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 2, n).astype(np.float32)
    bags = []
    for i in range(n):
        bag = rng.randn(rng.randint(3, L + 1), D).astype(np.float32)
        if y[i]:
            bag[rng.choice(len(bag), 2, replace=False)] += signal
        bags.append(bag)
    X, M = J.pad_bags(bags, L)
    return bags, X, M, y


def _jax_params(gated, seed=0):
    return jax.tree_util.tree_map(np.asarray, J.mil_init(jax.random.PRNGKey(seed), D, H, A, gated))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("gated", [False, True], ids=["plain", "gated"])
def test_mil_apply_and_predict_match_jax(gated):
    params = _jax_params(gated)
    _, X, M, _ = _bags(9, seed=1)
    M[4] = 0.0  # an all-masked bag
    want = np.asarray(J.mil_apply(params, jnp.asarray(X), jnp.asarray(M), gated=gated))
    tp = T.params_from_jax(params)
    got = T.mil_apply(tp, _t(X), _t(M), gated=gated)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        T.mil_predict(tp, _t(X), _t(M), gated).numpy(),
        np.asarray(J.mil_predict(params, jnp.asarray(X), jnp.asarray(M), gated)),
        atol=1e-5, rtol=0,
    )


def test_params_cross_over_as_copies():
    params = _jax_params(True)
    tp = T.params_from_jax(params)
    before = params["instance"]["w"].copy()
    tp["instance"]["w"].add_(1.0)  # must not reach the numpy arrays
    np.testing.assert_array_equal(params["instance"]["w"], before)
    back = T.params_to_numpy(tp)
    assert back.keys() == params.keys()
    np.testing.assert_array_equal(back["instance"]["w"], before + 1.0)
    np.testing.assert_array_equal(back["attn_w"]["b"], params["attn_w"]["b"])


def _jax_draws(key, epochs, n, batch_size, rate):
    """The JAX trainer's own draws (nn/mil.py: epoch keys, then per epoch
    the shuffle key and one dropout key per minibatch)."""
    n_batches = -(-n // batch_size)
    perms, keeps = [], []
    for ek in jax.random.split(key, epochs):
        perm_key, ek = jax.random.split(ek)
        perms.append(np.asarray(jax.random.permutation(perm_key, n)))
        keeps.append([np.asarray(jax.random.bernoulli(bk, 1.0 - rate, (batch_size, L, H)))
                      for bk in jax.random.split(ek, n_batches)])
    return np.stack(perms), np.asarray(keeps)


@pytest.mark.parametrize(
    "gated, epochs, patience, one_class_val",
    [(True, 2, 1, False), (False, 2, 0, False), (True, 4, 1, False), (True, 3, 0, True)],
    ids=["gated-2ep", "plain-2ep-nopatience", "gated-4ep-stops", "nan-auc-never-improves"],
)
def test_train_mil_impl_matches_jax_with_explicit_draws(gated, epochs, patience, one_class_val):
    n, batch, rate = 13, 4, 0.2
    _, X, M, y = _bags(n, seed=2)
    w_row = np.ones(n, np.float32)
    w_row[-2:] = 0.0  # cross-fold padding rows
    _, Xv, Mv, yv = _bags(8, seed=3, signal=0.8)
    if one_class_val:  # every epoch's AUC is NaN: the final params come back
        yv[:] = 1.0
    wv = np.ones(8, np.float32)
    wv[-1] = 0.0
    vmiss = np.zeros(8, np.float32)
    vmiss[2] = 1.0
    hp = dict(lr=1e-2, pos_weight=np.float32(1.3), max_grad_norm=np.float32(0.5),
              epochs=epochs, batch_size=batch, gated=gated, dropout=rate, weight_decay=1e-3,
              use_clip=True, track_best=True, patience=patience, missing_prob=0.5)
    params = _jax_params(gated, seed=4)
    key = jax.random.PRNGKey(5)

    static = ("epochs", "batch_size", "gated", "dropout", "weight_decay", "use_clip",
              "track_best", "patience", "missing_prob")
    jax_train = jax.jit(partial(J.train_mil_impl, **{k: hp[k] for k in static}))
    want = jax_train(
        params, jnp.asarray(X), jnp.asarray(M), jnp.asarray(y), jnp.asarray(w_row),
        jnp.asarray(Xv), jnp.asarray(Mv), jnp.asarray(yv), jnp.asarray(wv), key,
        hp["lr"], hp["pos_weight"], hp["max_grad_norm"], vmiss=jnp.asarray(vmiss),
    )

    perms, keeps = _jax_draws(key, epochs, n, batch, rate)
    got = T.train_mil_impl(
        T.params_from_jax(params), _t(X), _t(M), _t(y), _t(w_row), _t(Xv), _t(Mv), _t(yv),
        _t(wv), None, hp["lr"], float(hp["pos_weight"]), float(hp["max_grad_norm"]),
        epochs, batch, gated, rate, hp["weight_decay"], True, True, patience,
        vmiss=_t(vmiss), missing_prob=0.5, perms=torch.from_numpy(perms),
        dropout_keep=torch.from_numpy(keeps),
    )
    got = T.params_to_numpy(got)
    for layer, leaves in want.items():
        for name, value in leaves.items():
            np.testing.assert_allclose(got[layer][name], np.asarray(value), atol=1e-5, rtol=1e-4,
                                       err_msg=f"{layer}.{name}")
    # training moved the params (the comparison is not of the init)
    assert not np.allclose(got["instance"]["w"], params["instance"]["w"])


def test_linear_init_is_torch_linear_default_in_jax_layout():
    from pd_fusion_torch.nn.mlp import linear_init

    p = linear_init(torch.Generator().manual_seed(0), 64, 5)
    assert p["w"].shape == (64, 5) and p["b"].shape == (5,)
    assert p["w"].dtype == p["b"].dtype == torch.float32
    bound = 1.0 / 8.0
    assert float(p["w"].abs().max()) <= bound and float(p["b"].abs().max()) <= bound
    assert float(p["w"].abs().max()) > 0.9 * bound  # U(-bound, bound), not narrower
    again = linear_init(torch.Generator().manual_seed(0), 64, 5)  # the generator is the only source
    assert torch.equal(p["w"], again["w"]) and torch.equal(p["b"], again["b"])


def test_pad_bags_matches_jax():
    bags, _, _, _ = _bags(6, seed=10)
    for max_len in (None, L, 4):
        for got, want in zip(T.pad_bags(bags, max_len), J.pad_bags(bags, max_len)):
            np.testing.assert_array_equal(got, want)


def test_clip_by_global_norm_matches_optax():
    import optax

    rng = np.random.RandomState(0)
    # small gradients: an epsilon added to the norm (as torch's
    # clip_grad_norm_ adds 1e-6) would show at this scale
    grads = {"a": 1e-3 * rng.randn(3, 4).astype(np.float32),
             "b": 1e-3 * rng.randn(5).astype(np.float32)}
    for max_norm in (5e-4, 100.0):
        want, _ = optax.clip_by_global_norm(max_norm).update(
            {k: jnp.asarray(v) for k, v in grads.items()}, None)
        got = T._clip_by_global_norm([_t(grads["a"]), _t(grads["b"])],
                                     torch.tensor(max_norm, dtype=torch.float32))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want["a"]), atol=0, rtol=1e-6)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want["b"]), atol=0, rtol=1e-6)


def test_loss_safe_denominator_on_all_padding_batch():
    params = T.params_from_jax(_jax_params(True))
    for p in params.values():
        for v in p.values():
            v.requires_grad_(True)
    _, X, M, y = _bags(4, seed=6)
    loss = T._mil_loss(params, _t(X), _t(M), _t(y), torch.zeros(4), 2.0, True, 0.0)
    grads = torch.autograd.grad(loss, [params["instance"]["w"], params["attn_w"]["b"]])
    assert float(loss.detach()) == 0.0
    assert all(torch.count_nonzero(g) == 0 for g in grads)


def _model_params(gated):
    return {"hidden_dim": 32, "attn_dim": 16, "dropout": 0.1, "gated": gated, "lr": 5e-3,
            "batch_size": 16, "epochs": 40, "class_weight": "balanced", "max_grad_norm": 5.0,
            "early_stopping_patience": 10}


@pytest.mark.parametrize("gated", [False, True], ids=["plain", "gated"])
def test_mil_attention_model_learns_and_round_trips(gated, tmp_path):
    from sklearn.metrics import roc_auc_score

    from pd_fusion_torch.models.mil_attention import MilAttentionModel
    from pd_fusion_torch.utils.seed import set_seed

    set_seed(0)
    bags, _, _, y = _bags(120, seed=7)
    val_bags, _, _, y_val = _bags(40, seed=8)
    m = MilAttentionModel(D, _model_params(gated))
    m.train(bags, y, (val_bags, y_val))
    p = m.predict_proba(val_bags)
    assert roc_auc_score(y_val, p) > 0.8

    m.save(tmp_path / "mil.pt")
    m2 = MilAttentionModel.load(tmp_path / "mil.pt")
    np.testing.assert_allclose(p, m2.predict_proba(val_bags), atol=1e-6)


def test_mil_missing_bags_get_constant():
    from pd_fusion_torch.models.mil_attention import MilAttentionModel
    from pd_fusion_torch.utils.seed import set_seed

    set_seed(0)
    bags, _, _, y = _bags(60, seed=9)
    m = MilAttentionModel(D, {"hidden_dim": 16, "attn_dim": 8, "epochs": 3, "missing_prob": 0.42})
    m.train(bags, y)
    p = m.predict_proba([bags[0], None, bags[1]], {"mri": np.array([1, 1, 0])})
    assert p[1] == pytest.approx(0.42)
    assert p[2] == pytest.approx(0.42)
    assert p[0] != pytest.approx(0.42)
