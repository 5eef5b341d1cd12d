"""The JAX package's random draws, reproduced for the port's explicit-draws
seam (imported by the ``test_torch_port_tabular_*`` files), and a test
that a port run under ``use_jax_draws`` starts from the JAX run's weights.

The functions below split keys exactly as ``pd_fusion/nn/trainer.py``
and ``pd_fusion/nn/mlp.py`` do. ``use_jax_draws`` makes a whole port run
consume the JAX package's seed chain: every ``fresh_generator`` of the
tabular models and the CV engine hands out the JAX key that
``fresh_key`` would, ``mlp_init`` draws JAX's initial weights from it,
``moe_init`` likewise draws JAX's MoE weights, and the trainers' draw
functions make JAX's shuffles, modality keeps and dropout keeps. A port
run then reproduces the JAX run up to rounding.
"""
import contextlib

import jax
import numpy as np
import torch

from pd_fusion.nn import mlp as JM
from pd_fusion.nn import moe as JMoE
from pd_fusion.utils import seed as jseed


@contextlib.contextmanager
def one_cpu_thread():
    """Torch and every OpenMP pool (torch's, scikit-learn's) on one thread.
    The suite runs its files in parallel worker processes; the port's CPU
    paths are many tiny ops, and thread pools that contend for the same
    cores make them an order of magnitude slower."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


def dropout_keeps(key, rate, shapes):
    """mlp_apply's dropout draws: one split per hidden layer."""
    keeps = []
    for shape in shapes:
        key, sub = jax.random.split(key)
        keeps.append(np.asarray(jax.random.bernoulli(sub, 1.0 - rate, shape)))
    return keeps


def fullbatch_draws(key, epochs, n, hidden, rate):
    """fullbatch_impl's draws: one key per epoch -> per hidden layer [E, n, h]."""
    if rate <= 0.0:
        return None
    keeps = [dropout_keeps(k, rate, [(n, h) for h in hidden]) for k in jax.random.split(key, epochs)]
    return [np.stack([e[li] for e in keeps]) for li in range(len(hidden))]


def minibatch_draws(key, epochs, n, bs, n_mod, hidden, rate, md_rate, per_sample):
    """minibatch_moddrop_impl's draws: epoch keys; per epoch the shuffle
    key, then per batch a moddrop key and a dropout key."""
    nb = -(-n // bs)
    perms, mkeeps, dkeeps = [], [], []
    for ek in jax.random.split(key, epochs):
        perm_key, ek = jax.random.split(ek)
        perms.append(np.asarray(jax.random.permutation(perm_key, n)))
        mk_e, dk_e = [], []
        for bk in jax.random.split(ek, nb):
            mk, dk = jax.random.split(bk)
            shape = (bs, n_mod) if per_sample else (n_mod,)
            mk_e.append(np.asarray(jax.random.bernoulli(mk, 1.0 - md_rate, shape)))
            dk_e.append(dropout_keeps(dk, rate, [(bs, h) for h in hidden]) if rate else None)
        mkeeps.append(mk_e)
        dkeeps.append(dk_e)
    dropout_keep = None
    if rate:
        dropout_keep = [np.array([[b[li] for b in e] for e in dkeeps]) for li in range(len(hidden))]
    return np.stack(perms), np.array(mkeeps), dropout_keep


class JaxKey:
    """Stands where the port passes a ``torch.Generator``: the JAX key the
    JAX package draws at the same point of its seed chain."""

    def __init__(self, key):
        self.key = key


def use_jax_draws(monkeypatch):
    from pd_fusion_torch.experiments import run_experiment as TR
    from pd_fusion_torch.models import fusion_late, fusion_moddrop
    from pd_fusion_torch.models import moe as moe_model
    from pd_fusion_torch.nn import mlp as TM
    from pd_fusion_torch.nn import moe as TMoE
    from pd_fusion_torch.nn import trainer as TT
    from pd_fusion_torch.parallel import cv_engine
    from pd_fusion_torch.utils.seed import set_seed

    def both_set_seed(seed=42):
        set_seed(seed)
        jseed.set_seed(seed)

    def to_torch(a, device):
        if a is None:
            return None
        if isinstance(a, list):
            return [to_torch(x, device) for x in a]
        return torch.tensor(np.array(a, copy=True), device=device)

    def init(g, dims, device=None):
        params = jax.tree_util.tree_map(np.asarray, JM.mlp_init(g.key, list(dims)))
        return TM.mlp_params_from_jax(params, device=device)

    def init_moe(g, dims, expert_hidden, router_hidden, device=None):
        params = jax.tree_util.tree_map(np.asarray, JMoE.moe_init(
            g.key, dict(dims), list(expert_hidden), list(router_hidden)))
        return TMoE.moe_params_from_jax(params, device=device)

    def draw_fullbatch(g, epochs, n, hidden, dropout, device):
        return to_torch(fullbatch_draws(g.key, epochs, n, hidden, dropout), device)

    def draw_minibatch(g, epochs, n, bs, n_mod, hidden, dropout, md_rate, per_sample, device):
        return tuple(to_torch(a, device) for a in minibatch_draws(
            g.key, epochs, n, bs, n_mod, hidden, dropout, md_rate, per_sample))

    monkeypatch.setattr(TR, "set_seed", both_set_seed)
    for mod in (fusion_late, fusion_moddrop, moe_model, cv_engine):
        monkeypatch.setattr(mod, "fresh_generator", lambda device=None: JaxKey(jseed.fresh_key()))
    for mod in (TM, fusion_late, fusion_moddrop):
        monkeypatch.setattr(mod, "mlp_init", init)
    for mod in (TMoE, moe_model):
        monkeypatch.setattr(mod, "moe_init", init_moe)
    monkeypatch.setattr(TT, "draw_fullbatch", draw_fullbatch)
    monkeypatch.setattr(TT, "draw_minibatch", draw_minibatch)


def test_use_jax_draws_gives_the_jax_cv_engines_initial_weights(monkeypatch):
    """Under the seam the port's CV engine draws its fold generators from
    the JAX seed chain in the JAX engine's order (init, train per fold), so
    its stacked initial weights are the JAX engine's, bit for bit."""
    from pd_fusion.parallel import cv_engine as JC
    from pd_fusion_torch.parallel import cv_engine as TC

    monkeypatch.setenv("PD_FUSION_TORCH_DEVICE", "cpu")
    use_jax_draws(monkeypatch)
    dims = (7, 5, 1)
    jseed.set_seed(3)
    gens = [(TC.fresh_generator(), TC.fresh_generator()) for _ in range(3)]
    got = TC._init_folds_mlp([g for g, _ in gens], dims, "cpu")
    jseed.set_seed(3)
    drawn = [(jseed.fresh_key(), jseed.fresh_key()) for _ in range(3)]
    want = JC._init_folds_mlp(jax.numpy.stack([a for a, _ in drawn]), dims)
    for g, w in zip(got, want):
        for k in ("w", "b"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
