"""The MIL fine-tune of the port (``pd_fusion_torch/models/
mil_attention_finetune.py``, ``nn/ft_optim.py``) against the JAX package's,
on the CPU, at a small size: ResNet-18, 16^2 slices resized to 32^2, 4
slices a bag.

- One step (``ft_step``) against the JAX package's ``_ft_scan`` on the
  same parameters, batch and draws (dropout keeps from the JAX keys), with
  the gate at 0, at 1, and 0 then 1 (the backbone's Adam count advances
  while frozen), BCE and focal, on a batch with a ``None`` bag and a row
  padding a ragged batch: Adam moments within 1e-3 of their scale, counts
  equal, running statistics within 1e-5 of theirs, parameters within 5e-5
  (5% of one Adam step of the backbone) wherever the gradient is more than
  rounding noise (``_check_params``), and a frozen backbone bit for bit.
- The loss and its gradients against a JAX loss assembled from the JAX
  package's own functions as ``_ft_update`` assembles it: the loss to
  rtol 1e-5, the head's gradients within 1e-3 of their L2 norm; the
  backbone's gradients are 1-2% off float64 in both packages at this size
  (train-mode BN at a random init), so they are held against the port's
  float64 backbone (``test_torch_port_resnet._grad_close``), and the
  backbone's Adam moments within 5% (L2).
- A whole two-epoch run (12 bags, batch 5: ragged; the gate opens after
  epoch 1; validation AUC with early stopping): both packages get the
  same initial weights, ``np.random.Generator(PCG64(7))`` for every draw
  and the JAX keys' dropout keeps; the probabilities agree within 1e-3
  (1.9e-4 seen).
- The JAX tests' semantics held on the port: a frozen backbone is
  bit-frozen under weight decay while its running statistics move; the
  cross-fold slice cache and its budget; checkpoint and resume;
  ``missing_prob`` for absent bags. Artifacts load in both directions
  (predictions within 1e-5), and the CLI runs a tiny CV.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

import pd_fusion.models.mil_attention_finetune as JFT
from pd_fusion.imaging.nifti import write_nifti
from pd_fusion.nn import mil as JM
from pd_fusion.nn import resnet as JR
from pd_fusion.ops.image import affine2d_batch, slices_to_imagenet_batch
from pd_fusion.utils import seed as jseed
from pd_fusion_torch.models import mil_attention_finetune as TFT
from pd_fusion_torch.nn import ft_optim
from pd_fusion_torch.nn import mil as TM
from pd_fusion_torch.nn import resnet as TR
from pd_fusion_torch.utils.seed import set_seed
from test_torch_port_jax_draws import one_cpu_thread

ARCH, H, A, SIZE = "resnet18", 16, 8, 32
SMALL = {"backbone": ARCH, "pretrained": False, "target_shape": (16, 16, 16), "slice_axis": 2,
         "slice_count": 4, "input_size": SIZE, "hidden_dim": 32, "attn_dim": 16}
HYPER = {"lr_backbone": 1e-3, "lr": 3e-3, "weight_decay": 1e-2, "max_grad_norm": 1.0,
         "head_dropout": 0.2, "pos_weight": 1.5, "focal_gamma": 2.0, "focal_alpha": 0.25}
PARAM_ATOL = 5e-5
STATS_REL = 1e-5
BACKBONE_MOMENT_REL = 0.05  # L2; the backbone's float32 gradients, see _grad_close
HEAD_MOMENT_REL = 1e-2
RUN_ATOL = 1e-3


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("PD_FUSION_TORCH_DEVICE", "cpu")
    with one_cpu_thread():
        yield


@pytest.fixture(scope="module")
def synthetic_dataset(tmp_path_factory):
    """12 subjects; PD subjects have a bright blob (the JAX package's
    ``tests/test_imaging_integration.py`` fixture)."""
    root = tmp_path_factory.mktemp("nifti_ds")
    rng = np.random.RandomState(0)
    rows = []
    for i in range(12):
        label = i % 2
        vol = rng.rand(24, 28, 26).astype(np.float32) * 0.3
        vol[2:22, 2:26, 2:24] += 0.4  # foreground
        if label:
            vol[8:16, 8:16, 8:16] += 1.5
        p = root / f"sub-{i:02d}_T1w.nii.gz"
        write_nifti(p, vol)
        rows.append({"subject_id": f"sub-{i:02d}", "session": 1, "label": label,
                     "t1wbrain_path": str(p)})
    manifest = root / "manifest.csv"
    pd.DataFrame(rows).to_csv(manifest, index=False)
    return root, manifest


# ---- one step --------------------------------------------------------------

def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def start():
    """The JAX init's backbone with random running statistics (train mode
    does not read them; the EMA moves them), and a gated head. BN gamma
    and beta stay at their init: with random affines the early layers'
    gradients at this size are ill-conditioned (the port with and without
    oneDNN differs by 4% in L2 there, against 5e-5 at the init)."""
    jb = _np_tree(JR.init_resnet(jax.random.PRNGKey(0), ARCH))
    rs = np.random.RandomState(1)

    def spice(path, leaf):
        key = getattr(path[-1], "key", None)
        if key == "mean":
            return leaf + 0.1 * rs.randn(*leaf.shape).astype(np.float32)
        if key == "var":
            return leaf * (1.0 + 0.2 * rs.rand(*leaf.shape).astype(np.float32))
        return leaf

    jb = jax.tree_util.tree_map_with_path(spice, jb)
    jh = _np_tree(JM.mil_init(jax.random.PRNGKey(1), 512, H, A, True))
    return jb, jh


def step_batches(S, seed=2, B=4, L=4, hw=16):
    """[S, ...] batches: row 0 and 1 real bags (row 0 one slice short), row
    2 a ``None`` bag (zero slices, zero mask, valid), row 3 padding a
    ragged batch (valid 0); augmentation draws; dropout keeps from JAX keys."""
    rs = np.random.RandomState(seed)
    slices = rs.rand(S, B, L, hw, hw).astype(np.float32)
    mask = np.ones((S, B, L), np.float32)
    mask[:, 0, -1] = 0.0
    slices[:, 0, -1] = 0.0
    slices[:, 2:] = 0.0
    mask[:, 2:] = 0.0
    valid = np.tile(np.array([1, 1, 1, 0], np.float32), (S, 1))
    y = np.tile(np.array([1, 0, 1, 0], np.float32), (S, 1))
    keys = jax.random.split(jax.random.PRNGKey(seed), S)
    keep = np.stack([np.asarray(jax.random.bernoulli(k, 1.0 - HYPER["head_dropout"], (B, L, H)))
                     for k in keys])
    return {
        "slices": slices, "bag_mask": mask, "y": y, "valid": valid,
        "bn_mask": np.repeat(valid[:, :, None], L, 2),
        "angle": rs.uniform(-8, 8, (S, B)).astype(np.float32),
        "translate": rs.uniform(-1, 1, (S, B, 2)).astype(np.float32),
        "scale": (1 + rs.uniform(-0.15, 0.15, (S, B))).astype(np.float32),
        "shift": rs.uniform(-0.15, 0.15, (S, B)).astype(np.float32),
        "noise": (0.02 * rs.randn(S, B, L, hw, hw)).astype(np.float32),
        "keys": keys, "keep": keep,
    }


def _jax_scan(jb, jh, batches, gates, loss_type):
    tx = JFT._build_tx(HYPER["max_grad_norm"], HYPER["weight_decay"], HYPER["lr_backbone"],
                       HYPER["lr"])
    opt = tx.init({"backbone": jb, "head": jh})
    half = np.full(3, 0.5, np.float32)
    b = batches
    with jax.default_matmul_precision("highest"):
        nb, nh, nopt = JFT._ft_scan(
            jb, jh, opt, b["slices"], b["bag_mask"], b["y"], b["valid"], b["bn_mask"],
            b["angle"], b["translate"], b["scale"], b["shift"], b["noise"],
            np.asarray(gates, np.float32), b["keys"], half, half,
            np.float32(HYPER["pos_weight"]), np.float32(HYPER["focal_gamma"]),
            np.float32(HYPER["focal_alpha"]), tx_update=tx.update, arch=ARCH, gated=True,
            input_size=SIZE, loss_type=loss_type, train_bn=True,
            head_dropout=HYPER["head_dropout"])
    adam = {g: nopt[-1].inner_states[g].inner_state[0] for g in ("backbone", "head")}
    return _np_tree(nb), _np_tree(nh), adam


def hyper(loss_type):
    half = torch.full((3,), 0.5)
    return {"arch": ARCH, "gated": True, "input_size": SIZE, "mean": half, "std": half,
            "loss_type": loss_type, **HYPER}


def _port_batch(batches, s):
    out = {k: torch.from_numpy(np.ascontiguousarray(v[s])) for k, v in batches.items()
           if k != "keys"}
    return out


def _port_steps(jb, jh, batches, gates, loss_type):
    tb, th = TR.params_from_jax(jb), TM.params_from_jax(jh)
    state = {"backbone": ft_optim.init_group(TFT.trainable_leaves(tb)),
             "head": ft_optim.init_group(TFT.trainable_leaves(th))}
    for s, gate in enumerate(gates):
        tb, th, _ = TFT.ft_step(tb, th, state, _port_batch(batches, s), gate, hyper(loss_type))
    return tb, th, state


STEP_CASES = {
    "gate0_focal": ([0.0], "focal"),
    "gate1_focal": ([1.0], "focal"),
    "gate1_bce": ([1.0], "bce"),
    "gate0_then_1_bce": ([0.0, 1.0], "bce"),
}


def _check_params(got, want, mu, mu_port, lr, steps, what):
    """Adam's first steps are about +-lr a weight (each moment over its own
    root mean square), so where the two packages' first moments differ by
    more than half the moment (the gradient is within their float32
    disagreement; see ``_grad_close``) the sign may flip and the weights
    differ by up to 2 lr a step; and where the gradient is within 1000x
    Adam's eps (a first moment below 1e-6 after one step), the step is
    ``lr g / (|g| + eps)``, still a function of the gradient's magnitude.
    Everywhere else the weights agree within PARAM_ATOL. -> the share of
    the weights held to it."""
    err = np.abs(got - want)
    stable = (np.abs(mu) > 2 * np.abs(mu_port - mu)) & (np.abs(mu) > 1e-6)
    assert err[stable].max(initial=0.0) <= PARAM_ATOL, f"{what}: {err[stable].max():.3e}"
    assert err.max() <= 2 * lr * steps + PARAM_ATOL, f"{what}: {err.max():.3e}"
    return stable.mean()


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_ft_step_matches_jax_ft_scan(start, case):
    gates, loss_type = STEP_CASES[case]
    jb, jh = start
    batches = step_batches(len(gates))
    want_b, want_h, want_adam = _jax_scan(jb, jh, batches, gates, loss_type)
    got_b, got_h, state = _port_steps(jb, jh, batches, gates, loss_type)

    moments = {}
    for group, rel in (("backbone", BACKBONE_MOMENT_REL), ("head", HEAD_MOMENT_REL)):
        adam = want_adam[group]
        assert state[group]["count"] == int(adam.count) == len(gates)
        for name in ("mu", "nu"):
            want = [v for k, v in TFT._flatten(_np_tree(getattr(adam, name)[group]))
                    if k not in TR.BN_STATS]
            got = [t.numpy() for t in state[group][name]]
            if group == "backbone":
                got = [g.transpose(2, 3, 1, 0) if g.ndim == 4 else g for g in got]
            assert [g.shape for g in got] == [w.shape for w in want]
            for g, w in zip(got, want):
                assert np.linalg.norm(g - w) <= rel * max(np.linalg.norm(w), 1e-30), name
            moments[group, name] = (got, want)

    mu_b = iter(zip(*moments["backbone", "mu"]))
    n_moved, shares = 0, []
    for (key, g), (_, w), (_, w0) in zip(TFT._flatten(TR.params_to_jax(got_b)),
                                         TFT._flatten(want_b), TFT._flatten(jb)):
        if key in TR.BN_STATS:
            assert np.abs(g - w).max() <= STATS_REL * np.abs(w).max(), key
            assert not np.array_equal(w, w0)  # the EMA moved every running statistic
        else:
            mu_port, mu = next(mu_b)
            if gates[-1]:
                shares.append(_check_params(g, w, mu, mu_port, HYPER["lr_backbone"], 1, key))
            n_moved += not np.array_equal(g, w0)
    if gates[-1]:
        assert n_moved == len(TFT.trainable_leaves(got_b)) and np.mean(shares) > 0.9
    else:
        assert n_moved == 0  # a frozen step leaves every backbone weight bit for bit
    shares = [_check_params(g, w, mu, mu_port, HYPER["lr"], len(gates), key)
              for (key, g), (_, w), (mu_port, mu) in zip(
                  TFT._flatten(TM.params_to_numpy(got_h)), TFT._flatten(want_h),
                  zip(*moments["head", "mu"]))]
    assert np.mean(shares) > 0.9


def _jax_loss_fn(jb, jh, b, s, loss_type):
    """The JAX step's loss, assembled from the JAX package's functions as
    ``_ft_update`` assembles it."""
    B, L = b["slices"].shape[1:3]
    half = np.full(3, 0.5, np.float32)

    def loss_fn(bp, hp):
        aug = jax.vmap(affine2d_batch)(b["slices"][s], b["angle"][s], b["translate"][s])
        aug = jnp.clip(aug * b["scale"][s][:, None, None, None]
                       + b["shift"][s][:, None, None, None] + b["noise"][s], 0.0, 1.0)
        batch = slices_to_imagenet_batch(aug.reshape(B * L, *aug.shape[2:]), SIZE, half, half)
        emb, _ = JR.resnet_apply_train(bp, batch, ARCH, sample_weight=b["bn_mask"][s].reshape(-1))
        logits = JM.mil_apply(hp, emb.reshape(B, L, -1), b["bag_mask"][s], gated=True,
                              dropout_rate=HYPER["head_dropout"], dropout_key=b["keys"][s])
        y, valid = b["y"][s], b["valid"][s]
        p = jax.nn.sigmoid(logits)
        bce = jax.nn.softplus(logits) - y * logits
        denom = jnp.maximum(jnp.sum(valid), 1.0)
        if loss_type == "focal":
            pt = jnp.where(y >= 0.5, p, 1.0 - p)
            alpha = jnp.where(y >= 0.5, HYPER["focal_alpha"], 1.0 - HYPER["focal_alpha"])
            return jnp.sum(alpha * (1.0 - pt) ** HYPER["focal_gamma"] * bce * valid) / denom
        return jnp.sum(bce * jnp.where(y >= 0.5, HYPER["pos_weight"], 1.0) * valid) / denom

    return loss_fn


def _port_backbone_grads(jb, b, g_emb, dtype):
    """The port's backbone gradients for an upstream embedding gradient,
    computed in ``dtype`` (the augmentation and the backbone of
    ``ft_forward``)."""
    tb = TR.params_to(TR.params_from_jax(jb), dtype=dtype)
    leaves = TFT.trainable_leaves(tb)
    for t in leaves:
        t.requires_grad_(True)
    batch = {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in _port_batch(b, 0).items()}
    B, L = batch["slices"].shape[:2]
    aug = TFT.augment(batch["slices"], batch["angle"], batch["translate"], batch["scale"],
                      batch["shift"], batch["noise"])
    half = torch.full((3,), 0.5, dtype=dtype)
    x = TFT.slices_to_imagenet_batch(aug.reshape(B * L, *aug.shape[2:]), SIZE, half, half)
    with torch.backends.mkldnn.flags(enabled=False):
        emb, _ = TR.resnet_apply_train(tb, x, ARCH, sample_weight=batch["bn_mask"].reshape(-1))
        return torch.autograd.grad(torch.sum(emb * g_emb.to(dtype)), leaves)


@pytest.mark.parametrize("loss_type", ["bce", "focal"])
def test_ft_loss_and_gradients_match_a_jax_loss_assembled_from_its_functions(start, loss_type):
    """The loss to rtol 1e-5 and the head's gradients within 1e-3 (L2) of
    JAX's. The backbone's gradients at this size are 1-2% (L2) off float64
    in both packages, so they are held to ``_grad_close`` against the
    port's float64 backbone fed the same upstream gradient."""
    from test_torch_port_resnet import _grad_close

    jb, jh = start
    b = step_batches(1, seed=3)
    with jax.default_matmul_precision("highest"):
        loss, (g_b, g_h) = jax.value_and_grad(_jax_loss_fn(jb, jh, b, 0, loss_type),
                                              argnums=(0, 1))(jb, jh)
    tb, th = TR.params_from_jax(jb), TM.params_from_jax(jh)
    b_leaves, h_leaves = TFT.trainable_leaves(tb), TFT.trainable_leaves(th)
    for t in b_leaves + h_leaves:
        t.requires_grad_(True)
    B, L = b["slices"].shape[1:3]
    got, _ = TFT.ft_forward(tb, th, _port_batch(b, 0), hyper(loss_type))
    grads = torch.autograd.grad(got, b_leaves + h_leaves)
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)

    want_h = [np.asarray(v) for _, v in TFT._flatten(_np_tree(g_h))]
    # the attention scores' bias has a zero gradient (the softmax is shift
    # invariant): rounding noise in both, held to 1e-6 of the largest
    floor = 1e-6 * max(np.linalg.norm(w) for w in want_h)
    for g, w in zip(grads[len(b_leaves):], want_h):
        assert np.linalg.norm(g.numpy() - w) <= 1e-3 * max(np.linalg.norm(w), floor)

    # the upstream gradient at the embeddings, from the port's float32 head
    h = hyper(loss_type)
    batch = _port_batch(b, 0)
    with torch.no_grad():
        aug = TFT.augment(batch["slices"], batch["angle"], batch["translate"], batch["scale"],
                          batch["shift"], batch["noise"])
        x = TFT.slices_to_imagenet_batch(aug.reshape(B * L, *aug.shape[2:]), SIZE, h["mean"],
                                         h["std"])
        emb, _ = TR.resnet_apply_train(TR.params_from_jax(jb), x, ARCH,
                                       sample_weight=batch["bn_mask"].reshape(-1))
    emb.requires_grad_(True)
    logits = TM.mil_apply(TM.params_from_jax(jh), emb.reshape(B, L, -1), batch["bag_mask"],
                          gated=True, dropout_rate=HYPER["head_dropout"], dropout_keep=batch["keep"])
    loss_t = TFT.ft_loss(logits, batch["y"], batch["valid"], loss_type, h["pos_weight"],
                         h["focal_gamma"], h["focal_alpha"])
    (emb_grad,) = torch.autograd.grad(loss_t, [emb])
    ref = _port_backbone_grads(jb, b, emb_grad, torch.float64)
    want_b = [v for k, v in TFT._flatten(TR.params_from_jax(_np_tree(g_b))) if k not in TR.BN_STATS]
    assert len(ref) == len(want_b) == len(b_leaves)
    for (key, _), g, r, w in zip([kv for kv in TFT._flatten(tb) if kv[0] not in TR.BN_STATS],
                                 grads[:len(b_leaves)], ref, want_b):
        _grad_close(g.numpy(), r.numpy(), w.numpy(), f"gradient wrt {key}")


# ---- whole runs ------------------------------------------------------------

RUN_CFG = {**SMALL, "batch_size": 5, "epochs": 2, "freeze_backbone_epochs": 1, "train_aug": True,
           "max_grad_norm": 5.0, "dropout": 0.2, "early_stopping_patience": 2}


def _pcg7(*_):
    return np.random.Generator(np.random.PCG64(7))


@pytest.fixture(scope="module")
def runs(synthetic_dataset):
    """The same two-epoch run in both packages: JAX's initial weights carried
    over, every numpy draw from PCG64(7), the dropout keeps from the JAX
    package's key chain (one ``fresh_key`` for the head's init, then one a
    batch)."""
    _, manifest = synthetic_dataset
    df = pd.read_csv(manifest)
    bags, y = df["t1wbrain_path"].tolist(), df["label"].values
    hidden = RUN_CFG["hidden_dim"]

    jseed.set_seed(0)
    jseed.fresh_key()
    keys = [jseed.fresh_key() for _ in range(2 * 3)]

    mp = pytest.MonkeyPatch()
    mp.setattr(JFT.np.random, "default_rng", _pcg7)
    try:
        jseed.set_seed(0)
        jm = JFT.MilAttentionFineTuneModel(dict(RUN_CFG))
        jb0, jh0 = _np_tree(jm.backbone_params), _np_tree(jm.head_params)
        jm.train(bags, y, (bags, y))
        jp = jm.predict_proba(bags, {"mri": np.ones(len(bags), int)})
    finally:
        mp.undo()

    with one_cpu_thread():
        set_seed(0)
        tm = TFT.MilAttentionFineTuneModel(dict(RUN_CFG), device="cpu", make_rng=_pcg7)
        tm.backbone_params = TR.params_from_jax(jb0)
        tm.head_params = TM.params_from_jax(jh0)
        it = iter(keys)
        tm.train(bags, y, (bags, y), dropout_keep_fn=lambda B, L, h: np.asarray(
            jax.random.bernoulli(next(it), 1.0 - RUN_CFG["dropout"], (B, L, h))))
        tp = tm.predict_proba(bags, {"mri": np.ones(len(bags), int)})
    assert next(it, None) is None  # every JAX key was used, one a step
    return {"bags": bags, "y": y, "jax": jm, "port": tm, "jax_probs": jp, "port_probs": tp,
            "hidden": hidden}


def test_two_epoch_run_matches_jax(runs):
    jp, tp = runs["jax_probs"], runs["port_probs"]
    assert tp.shape == (12,) and np.isfinite(tp).all()
    np.testing.assert_allclose(tp, jp, atol=RUN_ATOL, rtol=0)
    assert np.ptp(tp) > 1e-4  # the run is not degenerate


def test_artifacts_load_in_both_directions(runs, tmp_path):
    from pd_fusion.models.serialization import load_model as jax_load_model
    from pd_fusion_torch.models.serialization import load_model

    bags, masks = runs["bags"], {"mri": np.ones(12, int)}
    runs["jax"].save(tmp_path / "jax.pt")
    port = load_model(tmp_path / "jax.pt")
    assert isinstance(port, TFT.MilAttentionFineTuneModel)
    np.testing.assert_allclose(port.predict_proba(bags, masks),
                               runs["jax"].predict_proba(bags, masks), atol=1e-5, rtol=0)

    runs["port"].save(tmp_path / "port.pt")
    back = jax_load_model(tmp_path / "port.pt")
    assert isinstance(back, JFT.MilAttentionFineTuneModel)
    np.testing.assert_allclose(back.predict_proba(bags, masks),
                               runs["port"].predict_proba(bags, masks), atol=1e-5, rtol=0)
    again = TFT.MilAttentionFineTuneModel.load(tmp_path / "port.pt")
    np.testing.assert_array_equal(again.predict_proba(bags, masks),
                                  runs["port"].predict_proba(bags, masks))


def test_predict_gives_missing_prob_for_absent_bags(runs):
    m, bags = runs["port"], runs["bags"]
    p = m.predict_proba([bags[0], None, bags[1]], {"mri": np.array([1, 0, 0])})
    assert p[1] == pytest.approx(m.missing_prob) and p[2] == pytest.approx(m.missing_prob)
    assert p[0] == pytest.approx(m.predict_proba([bags[0]])[0])
    assert np.all(m.predict_proba([None, None]) == np.float32(m.missing_prob))


def test_frozen_backbone_stays_bit_frozen_while_its_statistics_move(synthetic_dataset):
    _, manifest = synthetic_dataset
    df = pd.read_csv(manifest)
    set_seed(0)
    m = TFT.MilAttentionFineTuneModel({**SMALL, "batch_size": 4, "epochs": 1,
                                       "freeze_backbone_epochs": 1, "train_aug": False,
                                       "weight_decay": 1e-2})
    before = [(k, t.clone()) for k, t in TFT._flatten(m.backbone_params)]
    head_before = [t.clone() for t in TFT.trainable_leaves(m.head_params)]
    m.train(df["t1wbrain_path"].tolist(), df["label"].values)
    stat_moved = 0
    for (key, b), (_, a) in zip(before, TFT._flatten(m.backbone_params)):
        if key in TR.BN_STATS:
            stat_moved += not torch.equal(a, b)
        else:
            assert torch.equal(a, b), key
    assert stat_moved == 2 * 20  # every BN's mean and var (ResNet-18 has 20 BNs)
    assert m.opt_state["backbone"]["count"] == 3  # frozen steps still count
    assert all(float(t.abs().max()) == 0.0 for t in m.opt_state["backbone"]["mu"])
    assert any(not torch.equal(a, b) for a, b in zip(head_before,
                                                     TFT.trainable_leaves(m.head_params)))


def test_cross_fold_slice_cache_and_its_budget(synthetic_dataset, monkeypatch):
    _, manifest = synthetic_dataset
    bags = pd.read_csv(manifest)["t1wbrain_path"].tolist()
    cfg = {k: SMALL[k] for k in ("backbone", "pretrained", "target_shape", "slice_axis",
                                 "slice_count", "input_size")}
    calls = {"n": 0}
    real = TFT.native.prep_slices_native

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(TFT.native, "prep_slices_native", counting)
    TFT.SLICE_CACHE.clear()
    m1 = TFT.MilAttentionFineTuneModel(cfg)
    s1 = [m1._load_bag_slices(b) for b in bags]
    assert calls["n"] == len(bags)
    m2 = TFT.MilAttentionFineTuneModel(cfg)  # "fold 2"
    s2 = [m2._load_bag_slices(b) for b in bags]
    assert calls["n"] == len(bags)  # no volume prepped again
    assert all(a is b for a, b in zip(s1, s2))
    assert s1[0].shape == (4, 16, 16) and s1[0].dtype == np.float32
    TFT.MilAttentionFineTuneModel({**cfg, "slice_count": 3})._load_bag_slices(bags[0])
    assert calls["n"] == len(bags) + 1  # another prep config is another key

    monkeypatch.setenv("PD_FUSION_SLICE_CACHE_MB", "0")  # no sharing
    TFT.SLICE_CACHE.clear()
    m4 = TFT.MilAttentionFineTuneModel(cfg)
    m4._load_bag_slices(bags[0])
    n = calls["n"]
    TFT.MilAttentionFineTuneModel(cfg)._load_bag_slices(bags[0])
    assert calls["n"] == n + 1
    m4._load_bag_slices(bags[0])
    assert calls["n"] == n + 1  # the instance's own cache still holds it

    monkeypatch.setenv("PD_FUSION_SLICE_CACHE_MB", str(2 * s1[0].nbytes / 2**20))  # LRU of two
    TFT.SLICE_CACHE.clear()
    m6 = TFT.MilAttentionFineTuneModel(cfg)
    for b in bags[:3]:
        m6._load_bag_slices(b)
    key = lambda b: (str(b), m6.target_shape, tuple(m6.axes), tuple(m6.counts))  # noqa: E731
    assert TFT.SLICE_CACHE.get(key(bags[0])) is None
    assert TFT.SLICE_CACHE.get(key(bags[2])) is not None
    TFT.SLICE_CACHE.clear()


def test_slices_equal_the_jax_packages_prep(synthetic_dataset):
    _, manifest = synthetic_dataset
    bag = pd.read_csv(manifest)["t1wbrain_path"].iloc[1]
    cfg = {k: SMALL[k] for k in ("backbone", "pretrained", "target_shape", "slice_axis",
                                 "slice_count", "input_size")}
    got = TFT.MilAttentionFineTuneModel(cfg)._load_bag_slices(bag)
    want = JFT.MilAttentionFineTuneModel(cfg)._load_bag_slices(bag)
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def test_checkpoint_and_resume(synthetic_dataset, tmp_path):
    from pd_fusion_torch.utils.checkpoint import latest_step, load_checkpoint

    _, manifest = synthetic_dataset
    df = pd.read_csv(manifest)
    bags, y = df["t1wbrain_path"].tolist()[:6], df["label"].values[:6]
    cfg = {**SMALL, "batch_size": 3, "epochs": 2, "freeze_backbone_epochs": 1, "hidden_dim": 16,
           "attn_dim": 8, "train_aug": False, "checkpoint_dir": str(tmp_path / "ckpt"),
           "checkpoint_every": 1}
    set_seed(1)
    m1 = TFT.MilAttentionFineTuneModel(dict(cfg))
    m1.train(bags, y)
    assert latest_step(tmp_path / "ckpt") == 1
    state = load_checkpoint(tmp_path / "ckpt")
    assert state["epoch"] == 1 and state["opt_state"]["backbone"]["count"] == 4
    assert state["opt_state"]["head"]["count"] == 4

    set_seed(1)
    m2 = TFT.MilAttentionFineTuneModel(dict(cfg))
    m2.train(bags, y)  # start epoch 2 == epochs: a resume with no step left
    for a, b in zip(TFT._flatten({"b": m1.backbone_params, "h": m1.head_params}),
                    TFT._flatten({"b": m2.backbone_params, "h": m2.head_params})):
        assert torch.equal(a[1], b[1])
    assert m2.opt_state["backbone"]["count"] == 4

    # resume from epoch 0's state: one more epoch on top of it
    (tmp_path / "ckpt" / "LATEST").write_text("0")
    set_seed(1)
    m3 = TFT.MilAttentionFineTuneModel(dict(cfg))
    m3.train(bags, y)
    assert m3.opt_state["backbone"]["count"] == 4


def test_val_auc_maps_what_sklearn_refuses_to_minus_one():
    from sklearn.metrics import roc_auc_score

    y, p = np.array([0, 1, 1, 0, 1]), np.array([0.2, 0.7, 0.7, 0.4, 0.1], np.float32)
    assert TFT.val_auc(y, p) == pytest.approx(roc_auc_score(y, p), abs=1e-12)
    assert TFT.val_auc(np.ones(4), np.linspace(0, 1, 4)) == -1.0
    assert TFT.val_auc(y, np.array([0.1, np.nan, 0.3, 0.4, 0.5])) == -1.0


# ---- data and the CLI ------------------------------------------------------

def test_ds001907_ft_frame_matches_jax(synthetic_dataset, monkeypatch):
    from pd_fusion.data.openneuro_ds001907 import load_openneuro_ds001907 as jax_load
    from pd_fusion_torch.data.openneuro_ds001907 import load_openneuro_ds001907

    _, manifest = synthetic_dataset
    monkeypatch.setenv("PD_FUSION_DS001907_MANIFEST", str(manifest))
    got, got_masks = load_openneuro_ds001907({"feature_mode": "resnet2d_mil_ft"})
    want, want_masks = jax_load({"feature_mode": "resnet2d_mil_ft"})
    pd.testing.assert_frame_equal(got, want)
    for k in want_masks:
        np.testing.assert_array_equal(got_masks[k], want_masks[k])
    assert got["mri_mil"].tolist() == got["t1wbrain_path"].tolist()


def test_cli_runs_a_tiny_mil_finetune_cv(synthetic_dataset, tmp_path, monkeypatch):
    from pd_fusion_torch import cli
    from pd_fusion_torch.paths import ROOT_DIR

    _, manifest = synthetic_dataset
    monkeypatch.setenv("PD_FUSION_DS001907_MANIFEST", str(manifest))
    cfg = yaml.safe_load((ROOT_DIR / "configs/openneuro_ds001907_resnet2d_mil_ft.yaml").read_text())
    cfg["params"].update({**SMALL, "target_shape": [16, 16, 16], "epochs": 2,
                          "freeze_backbone_epochs": 1, "tta_inference": 2, "hidden_dim": 16,
                          "attn_dim": 8})
    cfg["cv_folds"] = 2
    cfg["calibration_split"] = 0.5  # a tenth of 6 training subjects is no split
    cfg["data_config"] = str(ROOT_DIR / cfg["data_config"])
    cfg["eval_config"] = str(ROOT_DIR / cfg["eval_config"])
    config = tmp_path / "ft.yaml"
    config.write_text(yaml.safe_dump(cfg))
    out = tmp_path / "run"
    agg = cli.main(["run", "--config", str(config), "--output-dir", str(out)])
    assert len(agg) == 7 and np.isfinite(agg["full_observation"]["roc_auc"]["mean"])
    names = {p.name for p in out.iterdir()}
    assert {"results_aggregated.yaml", "fold_assignments.csv", "summary_table.csv",
            "results_fold_1.yaml", "results_fold_2.yaml",
            "preds_fold_1_full_observation.csv", "preds_fold_2_full_observation.csv"} <= names
    assert agg["mri_missing_100"]["roc_auc"]["std"] == 0.0  # every bag absent: constant
