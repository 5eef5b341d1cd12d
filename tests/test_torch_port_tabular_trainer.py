"""The port's MLP core and tabular trainers (pd_fusion_torch/nn/mlp.py,
nn/trainer.py) against the JAX package's (pd_fusion/nn/mlp.py,
nn/trainer.py), with weights carried across and, for training, the JAX
package's own random draws fed through the explicit-draws seam.

Tolerances: forward 1e-6 absolute; params after 1-2 epochs 5e-5 absolute
(Adam steps over f32 sums taken in another order); the early-stopping
cases 1e-5, as ``tests/test_early_stopping_semantics.py`` holds the JAX
trainer to its oracle; the fold-batched trainer against K single runs
1e-6 absolute; 20 epochs within a stated band on loss and predictions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pd_fusion.nn import mlp as JM
from pd_fusion.nn import trainer as JT
from pd_fusion_torch.nn import mlp as TM
from pd_fusion_torch.nn import trainer as TT
from test_torch_port_jax_draws import dropout_keeps, fullbatch_draws, minibatch_draws

F, HID = 9, [8, 6]
ASSIGN = np.zeros((F, 3), np.float32)
ASSIGN[:4, 0] = ASSIGN[4:6, 1] = ASSIGN[6:, 2] = 1.0


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("PD_FUSION_TORCH_DEVICE", "cpu")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _problem(n, seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    beta = rng.randn(F).astype(np.float32)
    y = (X @ beta + 0.5 * rng.randn(n) > 0).astype(np.float32)
    return X, y


def _jax_params(seed, dims=None):
    return jax.tree_util.tree_map(
        np.asarray, JM.mlp_init(jax.random.PRNGKey(seed), dims or [F, *HID, 1]))


def _assert_params(got, want, atol, rtol=0.0):
    got = TM.mlp_params_to_numpy(got)
    assert len(got) == len(want)
    for li, (g, w) in enumerate(zip(got, want)):
        for k in ("w", "b"):
            np.testing.assert_allclose(g[k], np.asarray(w[k]), atol=atol, rtol=rtol,
                                       err_msg=f"layer {li} {k}")


# ---------------------------------------------------------------------------
# mlp_apply, bce, weights across
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dropout", [0.0, 0.3], ids=["no-dropout", "jax-dropout-masks"])
def test_mlp_apply_matches_jax(dropout):
    params = _jax_params(0)
    X, _ = _problem(17, seed=1)
    key = jax.random.PRNGKey(3) if dropout else None
    want = JM.mlp_apply(params, jnp.asarray(X), dropout_rate=dropout, dropout_key=key)
    keeps = dropout_keeps(key, dropout, [(17, h) for h in HID]) if dropout else None
    got = TM.mlp_apply(TM.mlp_params_from_jax(params), _t(X), dropout_rate=dropout,
                       dropout_keep=None if keeps is None else [_t(k) for k in keeps])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_mlp_apply_fold_batched_equals_each_fold():
    stacked = [jax.tree_util.tree_map(np.asarray, JM.mlp_init(jax.random.PRNGKey(s), [F, *HID, 1]))
               for s in range(3)]
    X = np.stack([_problem(11, seed=s)[0] for s in range(3)])
    tp = TM.mlp_params_from_jax(jax.tree_util.tree_map(lambda *a: np.stack(a), *stacked))
    got = TM.mlp_apply(tp, _t(X))
    for k in range(3):
        want = JM.mlp_apply(stacked[k], jnp.asarray(X[k]))
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_params_cross_over_as_copies():
    params = _jax_params(0)
    tp = TM.mlp_params_from_jax(params)
    before = params[0]["w"].copy()
    tp[0]["w"].add_(1.0)  # must not reach the numpy arrays
    np.testing.assert_array_equal(params[0]["w"], before)
    back = TM.mlp_params_to_numpy(tp)
    np.testing.assert_array_equal(back[0]["w"], before + 1.0)
    back[1]["b"][:] = 7.0  # nor the other way
    assert not torch.any(tp[1]["b"] == 7.0)


def test_mlp_init_is_torch_linear_default_in_jax_layout():
    p = TM.mlp_init(torch.Generator().manual_seed(0), [36, 5, 1])
    assert [tuple(l["w"].shape) for l in p] == [(36, 5), (5, 1)]
    assert float(p[0]["w"].abs().max()) <= 1 / 6 and float(p[0]["w"].abs().max()) > 0.9 / 6
    again = TM.mlp_init(torch.Generator().manual_seed(0), [36, 5, 1])
    assert all(torch.equal(a[k], b[k]) for a, b in zip(p, again) for k in ("w", "b"))


def test_bce_matches_jax_and_all_padding_batch_has_zero_loss_and_grads():
    rng = np.random.RandomState(0)
    z, y = rng.randn(12).astype(np.float32) * 5, rng.randint(0, 2, 12).astype(np.float32)
    w = rng.rand(12).astype(np.float32)
    for weights in (None, w):
        want = JM.bce_with_logits(jnp.asarray(z), jnp.asarray(y),
                                  None if weights is None else jnp.asarray(weights))
        got = TM.bce_with_logits(_t(z), _t(y), None if weights is None else _t(weights))
        np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=1e-6)

    params = TM.mlp_params_from_jax(_jax_params(0))
    leaves = [l[k].requires_grad_(True) for l in params for k in ("w", "b")]
    X, y = _problem(5, seed=2)
    loss = TM.bce_with_logits(TM.mlp_apply(params, _t(X)), _t(y), torch.zeros(5))
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == 0.0
    assert all(torch.count_nonzero(g) == 0 for g in grads)


# ---------------------------------------------------------------------------
# trainers with the JAX package's own draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True], ids=["mean", "weighted"])
@pytest.mark.parametrize("wd", [0.0, 1e-2], ids=["wd0", "wd"])
@pytest.mark.parametrize("epochs", [1, 2])
def test_fullbatch_matches_jax_with_its_draws(epochs, wd, weighted):
    n, rate, lr = 23, 0.25, 1e-2
    X, y = _problem(n, seed=4)
    w = np.ones(n, np.float32)
    w[-3:] = 0.0
    params = _jax_params(5)
    key = jax.random.PRNGKey(6)
    want = JT.train_fullbatch(params, jnp.asarray(X), jnp.asarray(y),
                              jnp.asarray(w) if weighted else None, key, lr, epochs, rate, wd)
    keeps = fullbatch_draws(key, epochs, n, HID, rate)
    got = TT.fullbatch_impl(TM.mlp_params_from_jax(params), _t(X), _t(y),
                            _t(w) if weighted else None, None, lr, epochs, rate, wd,
                            dropout_keep=[_t(k) for k in keeps])
    _assert_params(got, want, atol=5e-5)
    assert not np.allclose(TM.mlp_params_to_numpy(got)[0]["w"], params[0]["w"])


@pytest.mark.parametrize(
    "n, bs, per_sample, wd, epochs, rate",
    [(24, 8, False, 0.0, 1, 0.2), (23, 8, False, 1e-2, 2, 0.2), (23, 8, True, 0.0, 2, 0.2),
     (30, 7, True, 1e-2, 1, 0.0)],
    ids=["per-batch", "ragged-wd", "per-sample-ragged", "per-sample-nodropout"],
)
def test_minibatch_moddrop_matches_jax_with_its_draws(n, bs, per_sample, wd, epochs, rate):
    lr, md_rate = 1e-2, 0.4
    X, y = _problem(n, seed=7)
    w = np.ones(n, np.float32)
    w[2] = 0.0
    params = _jax_params(8)
    key = jax.random.PRNGKey(9)
    want = JT.train_minibatch_moddrop(
        params, jnp.asarray(X), jnp.asarray(y), jnp.asarray(w), jnp.asarray(ASSIGN), key, lr,
        epochs, bs, rate, wd, md_rate, per_sample)
    perms, mkeep, dkeep = minibatch_draws(key, epochs, n, bs, 3, HID, rate, md_rate, per_sample)
    got = TT.minibatch_moddrop_impl(
        TM.mlp_params_from_jax(params), _t(X), _t(y), _t(w), _t(ASSIGN), None, lr, epochs, bs,
        rate, wd, md_rate, per_sample, perms=_t(perms), moddrop_keep=_t(mkeep),
        dropout_keep=None if dkeep is None else [_t(k) for k in dkeep])
    _assert_params(got, want, atol=5e-5)
    assert not np.allclose(TM.mlp_params_to_numpy(got)[0]["w"], params[0]["w"])


def _bce(p, y):
    p = np.clip(p, 1e-7, 1 - 1e-7)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))


def test_minibatch_moddrop_20_epochs_stays_in_band_of_jax():
    """20 epochs chain ~100 Adam steps: rounding in another summation order
    compounds, so the two runs are held to a band (as
    tests/test_torch_equivalence.py:94 holds the JAX trainer to torch's
    Adam): training BCE within 0.02, predictions within 0.02 on average,
    and every prediction within 0.1."""
    n, bs, epochs, rate, md_rate, lr = 40, 8, 20, 0.1, 0.3, 1e-2
    X, y = _problem(n, seed=10)
    params = _jax_params(11)
    key = jax.random.PRNGKey(12)
    want = JT.train_minibatch_moddrop(
        params, jnp.asarray(X), jnp.asarray(y), jnp.ones(n), jnp.asarray(ASSIGN), key, lr,
        epochs, bs, rate, 0.0, md_rate, False)
    perms, mkeep, dkeep = minibatch_draws(key, epochs, n, bs, 3, HID, rate, md_rate, False)
    got = TT.minibatch_moddrop_impl(
        TM.mlp_params_from_jax(params), _t(X), _t(y), torch.ones(n), _t(ASSIGN), None, lr,
        epochs, bs, rate, 0.0, md_rate, False, perms=_t(perms), moddrop_keep=_t(mkeep),
        dropout_keep=[_t(k) for k in dkeep])
    p_jax = np.asarray(JT.predict_proba_jit(want, jnp.asarray(X)))
    p_port = TT.predict_proba(got, _t(X)).numpy()
    assert abs(_bce(p_jax, y) - _bce(p_port, y)) < 0.02
    assert float(np.mean(np.abs(p_jax - p_port))) < 0.02
    assert float(np.max(np.abs(p_jax - p_port))) < 0.1


# ---------------------------------------------------------------------------
# folds as a batch dimension
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("trainer", ["fullbatch", "minibatch", "minibatch-per-sample"])
def test_fold_batched_trainer_equals_single_runs(trainer):
    K, n, bs, epochs, lr = 3, 19, 6, 2, 1e-2
    Xs = np.stack([_problem(n, seed=20 + k)[0] for k in range(K)])
    ys = np.stack([_problem(n, seed=20 + k)[1] for k in range(K)])
    ws = np.ones((K, n), np.float32)
    ws[1, -4:] = 0.0  # a shorter fold padded to n
    params = [TM.mlp_params_from_jax(_jax_params(30 + k)) for k in range(K)]
    from pd_fusion_torch.parallel.cv_engine import _stack_params

    stacked = _stack_params(params)
    gens = lambda: [torch.Generator().manual_seed(40 + k) for k in range(K)]  # noqa: E731
    if trainer == "fullbatch":
        run = lambda p, X, y, w, g: TT.fullbatch_impl(p, X, y, w, g, lr, epochs, 0.3, 1e-3)  # noqa: E731
    else:
        per_sample = trainer.endswith("per-sample")
        run = lambda p, X, y, w, g: TT.minibatch_moddrop_impl(  # noqa: E731
            p, X, y, w, _t(ASSIGN), g, lr, epochs, bs, 0.3, 1e-3, 0.4, per_sample)
    got = run(stacked, _t(Xs), _t(ys), _t(ws), gens())
    for k, g in enumerate(gens()):
        want = TM.mlp_params_to_numpy(run(params[k], _t(Xs[k]), _t(ys[k]), _t(ws[k]), g))
        _assert_params([{kk: v[k] for kk, v in layer.items()} for layer in got], want,
                       atol=1e-6)


# ---------------------------------------------------------------------------
# early stopping: the five test_fullbatch_* cases of
# tests/test_early_stopping_semantics.py, against the JAX trainer
# ---------------------------------------------------------------------------


def _tab_data(seed=0, n=48, d=6, single_class_val=False):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    beta = rng.randn(d).astype(np.float32)
    y = (X @ beta + 0.8 * rng.randn(n) > 0).astype(np.float32)
    Xv = rng.randn(20, d).astype(np.float32)
    yv = (Xv @ beta + 0.8 * rng.randn(20) > 0).astype(np.float32)
    if single_class_val:
        yv = np.ones_like(yv)
    return X, y, Xv, yv


@pytest.mark.parametrize(
    "data_seed, key, init, epochs, patience, single_class, nan_rows",
    [(3, 7, 1, 40, 2, False, 0), (5, 11, 2, 25, -1, False, 0), (5, 11, 2, 25, 0, False, 0),
     (9, 13, 4, 30, 3, True, 0), (7, 17, 3, 20, 3, False, 3)],
    ids=["patience", "negative-is-best-over-all", "zero-breaks-at-first-plateau",
         "single-class-val-restores-epoch1", "nan-val-probs-are-auc-0"],
)
def test_fullbatch_earlystop_matches_jax(data_seed, key, init, epochs, patience, single_class,
                                         nan_rows):
    X, y, Xv, yv = _tab_data(seed=data_seed, single_class_val=single_class)
    Xv[:nan_rows] = np.nan
    p0 = jax.tree_util.tree_map(np.asarray, JM.mlp_init(jax.random.PRNGKey(init), [6, 16, 1]))
    want = JT.train_fullbatch_earlystop(
        p0, jnp.asarray(X), jnp.asarray(y), jnp.asarray(Xv), jnp.asarray(yv),
        jax.random.PRNGKey(key), 1e-2, np.float32(1.0), epochs, dropout=0.0, patience=patience)
    got = TT.train_fullbatch_earlystop(
        TM.mlp_params_from_jax(p0), _t(X), _t(y), _t(Xv), _t(yv), None, 1e-2, 1.0, epochs,
        dropout=0.0, patience=patience)
    _assert_params(got, want, atol=1e-5)
    assert all(np.isfinite(l[k]).all() for l in TM.mlp_params_to_numpy(got) for k in ("w", "b"))


def test_fullbatch_earlystop_pos_weight_and_dropout_match_jax():
    X, y, Xv, yv = _tab_data(seed=1)
    p0 = _jax_params(2, [6, 16, 1])
    key = jax.random.PRNGKey(3)
    want = JT.train_fullbatch_earlystop(
        p0, jnp.asarray(X), jnp.asarray(y), jnp.asarray(Xv), jnp.asarray(yv), key, 1e-2,
        np.float32(2.5), 2, dropout=0.3, patience=-1)
    keeps = fullbatch_draws(key, 2, 48, [16], 0.3)
    got = TT.train_fullbatch_earlystop(
        TM.mlp_params_from_jax(p0), _t(X), _t(y), _t(Xv), _t(yv), None, 1e-2, 2.5, 2,
        dropout=0.3, patience=-1, dropout_keep=[_t(k) for k in keeps])
    _assert_params(got, want, atol=5e-5)


def test_draws_are_made_from_the_generator_alone():
    X, y = _problem(20, seed=1)
    run = lambda: TT.minibatch_moddrop_impl(  # noqa: E731
        TM.mlp_params_from_jax(_jax_params(0)), _t(X), _t(y), torch.ones(20), _t(ASSIGN),
        torch.Generator().manual_seed(5), 1e-2, 2, 8, 0.2, 0.0, 0.3, False)
    a, b = run(), run()
    _assert_params(a, TM.mlp_params_to_numpy(b), atol=0.0)
    perms, mkeep, dkeep = TT.draw_minibatch(torch.Generator().manual_seed(0), 3, 20, 8, 3, HID,
                                            0.2, 0.3, True, "cpu")
    assert perms.shape == (3, 20) and mkeep.shape == (3, 3, 8, 3)
    assert [tuple(d.shape) for d in dkeep] == [(3, 3, 8, 8), (3, 3, 8, 6)]
    assert all(sorted(p.tolist()) == list(range(20)) for p in perms)
