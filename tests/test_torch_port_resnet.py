"""The port's ResNet-18/50 (``pd_fusion_torch/nn/resnet.py``) against the JAX
package's on the same weights and inputs (CPU).

The JAX pytree is carried over with ``params_from_jax``; BN statistics and
affines are randomized so that the fold is exercised. Tolerance: the JAX
test's own, ``atol=2e-4, rtol=1e-4`` (``tests/test_resnet.py``), with JAX
at ``highest`` matmul precision (true float32 convolutions). The torch
oracle of ``pd_fusion.utils.torch_utils.build_torch_resnet18`` (torchvision's
architecture and state_dict names) is held the same way through
``convert_torch_state_dict``.
"""
import jax
import numpy as np
import pytest
import torch
import torch.nn as nn

from pd_fusion.nn import resnet as JR
from pd_fusion.utils.torch_utils import build_torch_resnet18
from pd_fusion_torch.imaging.pipeline import fold_backbone
from pd_fusion_torch.nn import resnet as TR
from test_torch_port_jax_draws import one_cpu_thread

ATOL, RTOL = 2e-4, 1e-4


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("PD_FUSION_TORCH_DEVICE", "cpu")
    with one_cpu_thread():
        yield


def _spiced(arch, seed=3):
    """A JAX backbone with non-trivial BN running stats and affines."""
    params = JR.init_resnet(jax.random.PRNGKey(seed), arch)

    def spice(path, leaf):
        key = getattr(path[-1], "key", None)
        rs = np.random.RandomState(len(path) + 17 * sum(leaf.shape))
        if key in ("mean", "beta"):
            return leaf + 0.1 * rs.randn(*leaf.shape).astype(np.float32)
        if key in ("var", "gamma"):
            return leaf * (1.0 + 0.2 * rs.rand(*leaf.shape).astype(np.float32))
        return leaf

    return jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_map_with_path(spice, params))


@pytest.fixture(scope="module")
def backbones():
    return {arch: _spiced(arch) for arch in ("resnet18", "resnet50")}


def _x(n=2, size=32, seed=0):
    return np.random.RandomState(seed).rand(n, size, size, 3).astype(np.float32)


@pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_resnet_matches_jax_from_carried_over_weights(backbones, arch, folded):
    jp = backbones[arch]
    x = _x()
    tp = TR.params_from_jax(jp)
    with jax.default_matmul_precision("highest"):
        if folded:
            want = np.asarray(JR.resnet_apply_folded(JR.fold_bn_inference(jp, arch), x, arch))
        else:
            want = np.asarray(JR.resnet_apply(jp, x, arch, train=False))
    with torch.inference_mode():
        if folded:
            got = TR.resnet_apply_folded(TR.fold_bn_inference(tp, arch), torch.from_numpy(x), arch)
        else:
            got = TR.resnet_apply(tp, torch.from_numpy(x), arch)
    assert got.shape == want.shape == (2, TR.emb_dim(arch)) == (2, JR.emb_dim(arch))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_fold_matches_jax_fold_and_the_unfolded_forward(backbones):
    jp = backbones["resnet18"]
    tp = TR.params_from_jax(jp)
    want = TR.params_from_jax(jax.tree_util.tree_map(np.asarray, JR.fold_bn_inference(jp, "resnet18")))
    got = TR.fold_bn_inference(tp, "resnet18")
    flat = lambda t: [v for _, v in sorted(_leaves(t))]  # noqa: E731
    for a, b in zip(flat(got), flat(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
    x = torch.from_numpy(_x(seed=1))
    with torch.inference_mode():
        np.testing.assert_allclose(TR.resnet_apply_folded(got, x, "resnet18").numpy(),
                                   TR.resnet_apply(tp, x, "resnet18").numpy(), atol=ATOL, rtol=RTOL)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _torch_oracle():
    torch.manual_seed(0)
    model = build_torch_resnet18().eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.5, 0.5)
    return model


def test_resnet18_matches_the_torch_oracle_and_the_jax_conversion():
    model = _torch_oracle()
    sd = model.state_dict()
    x = _x(seed=2)
    with torch.no_grad():
        want = model(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    tp = TR.convert_torch_state_dict(sd, "resnet18")
    with torch.inference_mode():
        got = TR.resnet_apply(tp, torch.from_numpy(x), "resnet18").numpy()
        got_f = TR.resnet_apply_folded(TR.fold_bn_inference(tp, "resnet18"), torch.from_numpy(x),
                                       "resnet18").numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_f, want, atol=ATOL, rtol=RTOL)
    # the JAX package's conversion of the same state_dict, carried back
    jp = jax.tree_util.tree_map(np.asarray, JR.convert_torch_state_dict(sd, "resnet18"))
    for (ka, a), (kb, b) in zip(sorted(_leaves(TR.params_from_jax(jp))), sorted(_leaves(tp))):
        assert ka == kb
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("suffix", [".npz", ".pth"])
def test_load_backbone_reads_torchvision_named_weights(tmp_path, suffix):
    model = _torch_oracle()
    sd = model.state_dict()
    path = tmp_path / f"w{suffix}"
    if suffix == ".npz":
        np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    else:
        torch.save(sd, path)
    params, dim, pretrained = TR.load_backbone("resnet18", weights_path=path)
    assert (dim, pretrained) == (512, True)
    jp, jdim, jpre = JR.load_backbone("resnet18", weights_path=path)
    assert (jdim, jpre) == (dim, pretrained)
    for (ka, a), (kb, b) in zip(sorted(_leaves(params)),
                                sorted(_leaves(TR.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))))):
        assert ka == kb
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_seeded_init_is_deterministic_and_shaped_like_jax():
    a, dim, pretrained = TR.load_backbone("resnet50", seed=4)
    b, _, _ = TR.load_backbone("resnet50", seed=4)
    c, _, _ = TR.load_backbone("resnet50", seed=5)
    assert (dim, pretrained) == (2048, False)
    ja = TR.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                   JR.init_resnet(jax.random.PRNGKey(0), "resnet50")))
    la, lb, lc, lj = (sorted(_leaves(t)) for t in (a, b, c, ja))
    assert [k for k, _ in la] == [k for k, _ in lj]
    for (_, u), (_, v), (_, w), (_, z) in zip(la, lb, lc, lj):
        assert u.shape == z.shape
        assert torch.equal(u, v)
    assert not torch.equal(a["conv1"]["w"], c["conv1"]["w"])
    # He-normal, fan_out: the stem's std is sqrt(2 / (7 * 7 * 64))
    stem = a["conv1"]["w"]
    assert abs(float(stem.std()) - (2 / (7 * 7 * 64)) ** 0.5) < 0.01


def test_train_mode_is_not_ported_yet(backbones):
    with pytest.raises(NotImplementedError, match="item 11"):
        TR.resnet_apply(TR.params_from_jax(backbones["resnet18"]), torch.zeros(1, 32, 32, 3),
                        "resnet18", train=True)


def test_bfloat16_backbone_folds_in_float32_then_casts(backbones):
    """``compute_dtype: bfloat16``: BN folded in float32, then the weights
    cast; the embeddings stay close to float32's (cosine >= 0.99)."""
    tp = TR.params_from_jax(backbones["resnet18"])
    f32 = fold_backbone(tp, "resnet18", "float32")
    bf16 = fold_backbone(tp, "resnet18", "bfloat16")
    for (_, a), (_, b) in zip(sorted(_leaves(f32)), sorted(_leaves(bf16))):
        assert b.dtype == torch.bfloat16
        assert torch.equal(a.to(torch.bfloat16), b)
    x = torch.from_numpy(_x(seed=3))
    with torch.inference_mode():
        e32 = TR.resnet_apply_folded(f32, x, "resnet18")
        e16 = TR.resnet_apply_folded(bf16, x.to(torch.bfloat16), "resnet18").float()
    cos = torch.nn.functional.cosine_similarity(e32, e16, dim=1)
    assert bool((cos >= 0.99).all()), cos
    with pytest.raises(ValueError, match="compute_dtype"):
        fold_backbone(tp, "resnet18", "float16")
