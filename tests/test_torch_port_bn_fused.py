"""The backbone's fused train-mode BN (``pd_fusion_torch/ops/weighted_bn.py``):
its plain version against the torch-op composition it replaces
(``_bn_train``'s formulas, then ``+ identity`` and ReLU, under autograd),
its place in ``resnet_apply_train`` and the fine-tune step, its counters,
its launch arithmetic, and, on a card (``cuda`` marker), the kernels
against the plain version at every BN shape of both ResNet steps.

The module imports no JAX, so it runs on a GPU machine too:
``python -m pytest tests/test_torch_port_bn_fused.py -q``. The JAX
package's comparisons of ``resnet_apply_train`` are
``tests/test_torch_port_resnet.py`` and ``test_torch_port_finetune.py``.
"""
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from pd_fusion_torch.models import ft_checks as fc
from pd_fusion_torch.models import mil_attention_finetune as ft
from pd_fusion_torch.nn import resnet as R
from pd_fusion_torch.nn.mil import mil_init
from pd_fusion_torch.ops import weighted_bn as wbn
from pd_fusion_torch.ops import weighted_bn_checks as wc
from pd_fusion_torch.utils import profiling

# (residual, relu) after a BN: block BNs and the stem (ReLU), a block's last
# BN (residual and ReLU), a downsample BN (neither); and the fourth form.
FORMS = [(False, True), (True, True), (False, False), (True, False)]
WEIGHTS = {"zeros": [1.0, 0.0, 1.0, 1.0, 0.0], "ragged": [1.0, 1.0, 1.0, 0.0, 0.0], "none": None}
REL = {torch.float64: 1e-10, torch.float32: 2e-5}  # of each output's largest magnitude


def _composition(x, p, momentum, w, identity, relu):
    """Today's torch-op BN: ``_bn_train``'s weighted formulas (the unweighted
    ones without ``w``), then the add and the ReLU of ``_block``."""
    if w is None:
        mean = torch.mean(x, dim=(0, 2, 3))
        var = torch.var(x, dim=(0, 2, 3), correction=0)
        n = x.shape[0] * x.shape[2] * x.shape[3]
        unbiased = var * (n / max(n - 1, 1))
    else:
        wb = w[:, None, None, None]
        n = torch.sum(w) * (x.shape[2] * x.shape[3])
        mean = torch.sum(x * wb, dim=(0, 2, 3)) / n
        var = torch.sum(torch.square(x - mean[:, None, None]) * wb, dim=(0, 2, 3)) / n
        unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
    y = R._normalize(x, mean, var, p)
    if identity is not None:
        y = y + identity
    if relu:
        y = torch.relu(y)
    return y, ((1.0 - momentum) * p["mean"] + momentum * mean.detach(),
               (1.0 - momentum) * p["var"] + momentum * unbiased.detach())


def _inputs(dtype, weights, residual, seed=0, shape=(5, 8, 3, 4)):
    inp = wc.bn_inputs(shape, residual, seed, "cpu", dtype)
    inp["w"] = None if weights is None else torch.tensor(weights, dtype=dtype)
    gy = wc.bn_inputs(shape, False, seed + 1, "cpu", dtype)["x"]
    return inp, gy


def _close(a, b, dtype, what):
    a, b = a.detach(), b.detach()
    err = float((a - b).abs().max())
    assert err <= REL[dtype] * max(float(b.abs().max()), 1e-30), (what, err)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("weights", sorted(WEIGHTS))
@pytest.mark.parametrize("residual,relu", FORMS)
def test_plain_version_matches_the_torch_op_composition(dtype, weights, residual, relu):
    """Forward, running statistics and the gradients of x, gamma, beta and
    the identity through ``bn_train`` on the CPU (the plain version) against
    autograd of the composition it replaced."""
    inp, gy = _inputs(dtype, WEIGHTS[weights], residual)
    leaves = {k: inp[k].detach().requires_grad_(True) for k in ("x", "gamma", "beta")}
    if residual:
        leaves["identity"] = inp["identity"].detach().requires_grad_(True)
    p = {"gamma": leaves["gamma"], "beta": leaves["beta"], "mean": inp["running_mean"],
         "var": inp["running_var"]}
    before = wbn.launch_counts["plain"]
    got, got_p = wbn.bn_train(leaves["x"], p, 0.1, R.BN_EPS, inp["w"], leaves.get("identity"),
                              relu)
    got_g = torch.autograd.grad(got, list(leaves.values()), gy)
    assert wbn.launch_counts["plain"] == before + 2  # one forward, one backward
    want, (want_mean, want_var) = _composition(leaves["x"], p, 0.1, inp["w"],
                                               leaves.get("identity"), relu)
    want_g = torch.autograd.grad(want, list(leaves.values()), gy)
    _close(got, want, dtype, "y")
    _close(got_p["mean"], want_mean, dtype, "running mean")
    _close(got_p["var"], want_var, dtype, "running variance")
    assert not got_p["mean"].requires_grad and not got_p["var"].requires_grad
    for name, a, b in zip(leaves, got_g, want_g):
        _close(a, b, dtype, f"d{name}")


@pytest.mark.parametrize("weights", sorted(WEIGHTS))
@pytest.mark.parametrize("residual,relu", FORMS)
def test_backward_formula_matches_autograd(weights, residual, relu):
    """``backward_plain`` (the formula the kernels compute) against autograd
    of ``forward_plain`` itself, float64."""
    inp, gy = _inputs(torch.float64, WEIGHTS[weights], residual, seed=4)
    x = inp["x"].detach().requires_grad_(True)
    gamma = inp["gamma"].detach().requires_grad_(True)
    beta = inp["beta"].detach().requires_grad_(True)
    identity = inp["identity"].detach().requires_grad_(True) if residual else None
    y, stats, _, _ = wbn.forward_plain(x, gamma, beta, inp["w"], identity, relu,
                                       inp["running_mean"], inp["running_var"], 0.1, R.BN_EPS)
    wrt = [x, gamma, beta] + ([identity] if residual else [])
    want = torch.autograd.grad(y, wrt, gy)
    dx, dgamma, dbeta, did = wbn.backward_plain(gy, x.detach(), y.detach(), stats.detach(),
                                                gamma.detach(), inp["w"], relu, residual)
    for name, a, b in zip(["dx", "dgamma", "dbeta", "didentity"], [dx, dgamma, dbeta, did], want):
        _close(a, b, torch.float64, name)
    assert (did is not None) == residual


def test_without_gradients_the_forward_runs_alone():
    """Under ``no_grad`` (the frozen step) autograd records no node for the
    Function, and its output and running statistics equal those of a call
    that records one."""
    inp, _ = _inputs(torch.float32, WEIGHTS["ragged"], True)
    p = {"gamma": inp["gamma"], "beta": inp["beta"], "mean": inp["running_mean"],
         "var": inp["running_var"]}
    with_grad = wbn.bn_train(inp["x"].requires_grad_(True), p, 0.1, R.BN_EPS, inp["w"],
                             inp["identity"], True)
    assert with_grad[0].grad_fn is not None
    with torch.no_grad():
        y, new_p = wbn.bn_train(inp["x"], p, 0.1, R.BN_EPS, inp["w"], inp["identity"], True)
    assert y.grad_fn is None and torch.equal(y, with_grad[0].detach())
    for k in ("mean", "var"):
        assert torch.equal(new_p[k], with_grad[1][k])


def test_the_census_of_a_step():
    """ResNet-50 runs 53 BNs a forward (1 stem, 16 blocks' 3, 4 downsample),
    ResNet-18 20 (1, 8 x 2, 3): every block's last BN takes the residual and
    the ReLU, a downsample BN neither, every other one the ReLU."""
    for arch, n, blocks, downsample in (("resnet50", 53, 16, 4), ("resnet18", 20, 8, 3)):
        calls = wc.bn_calls(arch, 224, 256)
        forms = {}
        for (shape, residual, relu), count in calls.items():
            forms[(residual, relu)] = forms.get((residual, relu), 0) + count
            assert shape[0] == 256 and shape[1] % 64 == 0
        assert sum(calls.values()) == n
        assert forms[(True, True)] == blocks and forms[(False, False)] == downsample
        assert forms[(False, True)] == n - blocks - downsample
        stem = next(iter(calls))
        assert stem == ((256, 64, 112, 112), False, True)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_launch_config_tiles_every_step_shape(arch):
    """The tiling of each BN shape of the step: every row and channel
    covered, whole row groups a tile, and about one wave of blocks."""
    for (N, C, H, W), _, _ in wc.bn_calls(arch, 224, 256):
        R_ = N * H * W
        cfg = wbn.launch_config(R_, C)
        assert cfg.lanes * cfg.row_lanes == wbn.THREADS
        assert cfg.chunks * cfg.lanes * 4 >= C > (cfg.chunks - 1) * cfg.lanes * 4
        assert cfg.rows_per_tile % (cfg.row_lanes * wbn.UNROLL) == 0
        assert (cfg.tiles - 1) * cfg.rows_per_tile < R_ <= cfg.tiles * cfg.rows_per_tile
        assert wbn.TARGET_BLOCKS // 2 <= cfg.tiles * cfg.chunks <= wbn.TARGET_BLOCKS
        assert cfg.tiles < 65_536 and cfg.chunks < 65_536


def test_launch_config_small_and_odd_shapes():
    assert wbn.launch_config(4, 2048) == (64, 4, 8, 1, 16)
    assert wbn.launch_config(1, 4) == (1, 256, 1, 1, 1024)
    cfg = wbn.launch_config(1000, 96)  # 24 channel vectors: lanes 32, the last 8 idle
    assert (cfg.lanes, cfg.chunks) == (32, 1)
    for bad in ((0, 64), (10, 66), (10, 2)):
        with pytest.raises(ValueError):
            wbn.launch_config(*bad)


def test_the_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """Checked before any build: float32 alone, on a CUDA device."""
    x = torch.zeros(2, 8, 3, 3).to(memory_format=torch.channels_last)
    c = torch.zeros(8)
    with pytest.raises(TypeError):
        wbn.launch_kernel_forward(x.double(), c, c, None, None, True, c, c, 0.1, 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        wbn.launch_kernel_forward(x, c, c, None, None, True, c, c, 0.1, 1e-5)
    with pytest.raises(ValueError, match=r"\[N, C, H, W\]"):
        wbn.launch_kernel_backward(x[0], x[0], x[0], torch.zeros(17), c, None, True, False)


def test_counters_count_calls_while_tracing():
    inp, gy = _inputs(torch.float32, None, False)
    p = {"gamma": inp["gamma"].requires_grad_(True), "beta": inp["beta"],
         "mean": inp["running_mean"], "var": inp["running_var"]}
    profiling.reset()
    y, _ = wbn.bn_train(inp["x"], p, 0.1, R.BN_EPS, relu=True)
    assert profiling.snapshot()["counters"] == {}  # tracing off: nothing
    with profiling.tracing():
        y, _ = wbn.bn_train(inp["x"], p, 0.1, R.BN_EPS, relu=True)
        torch.autograd.grad(y, [p["gamma"]], gy)
    assert profiling.snapshot()["counters"] == {"backbone:bn_plain": 2}
    profiling.reset()


def _step_args(arch, device, inputs):
    """(backbone, head, Adam state, batch, hyper) of one ``ft_step`` from the
    seeded ``arch`` and a gated head on ``device``."""
    backbone, dim, _ = ft.load_backbone(arch, seed=0)
    head = mil_init(torch.Generator().manual_seed(1), dim, fc.HIDDEN, fc.ATTN, True)
    bp, hp = R.params_to(backbone, device=device), R.params_to(head, device=device)
    opt = {"backbone": ft.ft_optim.init_group(ft.trainable_leaves(bp)),
           "head": ft.ft_optim.init_group(ft.trainable_leaves(hp))}
    batch = {k: torch.as_tensor(v, device=device) for k, v in inputs.items()}
    return bp, hp, opt, batch, dict(fc.hyper(device), arch=arch)


def _step_calls(monkeypatch, arch, gate):
    """One tiny ``ft_step`` on the CPU -> (plain forwards, plain backwards,
    the ``backbone:bn_plain`` counter)."""
    calls = {"forward": 0, "backward": 0}
    for name, fn in (("forward", wbn.forward_plain), ("backward", wbn.backward_plain)):
        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(wbn, f"{name}_plain", counted)
    backbone, head, opt, batch, hyper = _step_args(arch, "cpu", fc.step_inputs(2, 2, 32, seed=3))
    hyper["input_size"] = 32
    profiling.reset()
    with profiling.tracing():
        new_b, _, loss = ft.ft_step(backbone, head, opt, batch, gate, hyper)
    counter = profiling.snapshot()["counters"].get("backbone:bn_plain")
    profiling.reset()
    assert np.isfinite(float(loss))
    moved = [k for k, t in ft._flatten(new_b) if k in R.BN_STATS]
    assert len(moved) == 2 * (53 if arch == "resnet50" else 20)
    return calls["forward"], calls["backward"], counter


@pytest.mark.parametrize("arch,forward,backward", [("resnet50", 53, 53), ("resnet18", 20, 20)])
def test_an_unfrozen_step_counts_its_bns(monkeypatch, arch, forward, backward):
    """An unfrozen ``ft_step``: every BN's forward once and its backward
    once, each one call of the fused BN."""
    f, b, counter = _step_calls(monkeypatch, arch, 1.0)
    assert (f, b) == (forward, backward)
    assert counter == forward + backward


def test_a_frozen_step_runs_the_forward_alone(monkeypatch):
    f, b, counter = _step_calls(monkeypatch, "resnet50", 0.0)
    assert (f, b, counter) == (53, 0, 53)


def test_the_group_path_keeps_its_torch_ops(monkeypatch):
    """``resnet_apply_train(group=)`` takes ``_bn_train_group`` and never
    the fused BN; with the all-reduce the identity (a group of one) it
    computes what the fused path computes, gradients included."""
    from pd_fusion_torch.parallel import distributed

    f64 = torch.float64
    params = R.params_to(R.init_resnet(torch.Generator().manual_seed(2), "resnet18"), dtype=f64)
    leaves = [params["conv1"]["w"], params["bn1"]["gamma"], params["layer4"][1]["bn2"]["beta"]]
    for t in leaves:
        t.requires_grad_(True)
    x = torch.rand(3, 32, 32, 3, generator=torch.Generator().manual_seed(3), dtype=f64)
    w = torch.tensor([1.0, 1.0, 0.0], dtype=f64)
    want, want_p = R.resnet_apply_train(params, x, "resnet18", sample_weight=w)
    want_g = torch.autograd.grad(want.sum(), leaves)
    monkeypatch.setattr(distributed, "all_reduce_differentiable", lambda t, group: t)
    monkeypatch.setattr(wbn, "bn_train", lambda *a, **k: pytest.fail("the fused BN ran"))
    got, got_p = R.resnet_apply_train(params, x, "resnet18", sample_weight=w, group=object())
    got_g = torch.autograd.grad(got.sum(), leaves)
    _close(got, want, f64, "embeddings")
    _close(got_p["layer3"][0]["downsample"]["bn"]["var"],
           want_p["layer3"][0]["downsample"]["bn"]["var"], f64, "running variance")
    for i, (a, b) in enumerate(zip(got_g, want_g)):
        _close(a, b, f64, f"gradient {i}")


@pytest.mark.parametrize("residual,relu", FORMS)
def test_the_checks_pass_on_the_cpu(residual, relu):
    """``weighted_bn_checks.check_call``, the card test's check, on the CPU
    (the plain version through the Function against float64)."""
    out = wc.check_call((4, 64, 5, 5), residual, relu, "cpu", seed=2)
    assert ("didentity" in out) == residual and len(out) == 6 + residual


def test_the_check_gates_each_sides_gradients_by_its_own_relu_mask():
    """``check_call``'s float64 backward takes the tested side's ReLU mask:
    with the version's own output it is the plain backward; an output on
    the other side of 0 at one element moves that element's gradient
    alone, besides the sums' share of it in every row."""
    inp = wc.bn_inputs((8, 8, 6, 6), False, 3, "cpu", torch.float64)
    gy = wc.bn_inputs((8, 8, 6, 6), False, 4, "cpu", torch.float64)["x"]
    own = wc._plain(inp, True, gy, torch.float64)
    y = wbn.forward_plain(inp["x"], inp["gamma"], inp["beta"], inp["w"], None, True,
                          inp["running_mean"], inp["running_var"], wc.MOMENTUM, wc.EPS)[0]
    for k, v in wc._plain(inp, True, gy, torch.float64, y).items():
        assert torch.equal(v, own[k]), k
    at = tuple(int(v) for v in torch.nonzero(y > 0)[0])
    flipped = y.clone()
    flipped[at] = 0.0
    moved = (wc._plain(inp, True, gy, torch.float64, flipped)["dx"] - own["dx"]).abs()
    elsewhere = moved.clone()
    elsewhere[at] = 0.0
    assert float(moved[at]) > 5 * float(elsewhere.max())
    assert float(elsewhere[:, at[1] + 1:].max()) == 0.0  # other channels keep their gradients


# ---- on the card ----

STEP_CALLS = sorted({call for arch in ("resnet50", "resnet18")
                     for call in wc.bn_calls(arch, 224, 256)})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    from pd_fusion_torch.utils.device import get_device

    get_device(torch.device("cuda"))  # TF32 off
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,residual,relu", STEP_CALLS,
                         ids=["x".join(map(str, s)) + f"-res{int(r)}-relu{int(u)}"
                              for s, r, u in STEP_CALLS])
def test_kernels_match_the_plain_version_at_every_step_shape(cuda, shape, residual, relu):
    """Every BN shape of the ResNet-50 and ResNet-18 steps (256 images of
    224^2), 1 in 4 images at weight 0: the kernels' outputs no further from
    float64 than ``ERROR_FACTOR`` times the float32 plain version's, or
    ``ERROR_FLOOR`` (both orders of float32 sums round; the kernels'
    float64 merge of the tiles is the more exact), twice equal bit for bit."""
    wc.check_call(shape, residual, relu, cuda, seed=sum(shape))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 8, 5, 7), (6, 2048, 1, 1), (2, 100, 9, 9)])
def test_kernels_on_small_unweighted_and_ragged_shapes(cuda, shape):
    """Tiles shorter than a row group, one pixel an image, C = 100 (the
    last lanes idle), with and without weights."""
    for weighted in (True, False):
        for residual, relu in FORMS:
            wc.check_call(shape, residual, relu, cuda, seed=1, weighted=weighted)
            torch.cuda.synchronize()


@pytest.mark.cuda
def test_launches_a_call_and_the_refusals(cuda):
    """Three launches a call; the wrappers refuse another dtype, a layout
    other than channels-last, an address off 16 bytes and C % 4."""
    inp = wc.bn_inputs((4, 64, 6, 6), True, 0, cuda)
    args = (inp["x"], inp["gamma"], inp["beta"], inp["w"], inp["identity"], True,
            inp["running_mean"], inp["running_var"], 0.1, 1e-5)
    before = wbn.launch_counts["kernel"]
    y, stats, _, _ = wbn.launch_kernel_forward(*args)
    torch.cuda.synchronize()
    assert wbn.launch_counts["kernel"] == before + 3
    wbn.launch_kernel_backward(inp["x"], inp["x"], y, stats, inp["gamma"], inp["w"], True, True)
    torch.cuda.synchronize()
    assert wbn.launch_counts["kernel"] == before + 6
    with pytest.raises(TypeError):
        wbn.launch_kernel_forward(inp["x"].double(), *args[1:])
    with pytest.raises(ValueError, match="channels-last"):
        wbn.launch_kernel_forward(inp["x"].contiguous(), *args[1:])
    off = torch.empty(inp["x"].numel() + 1, device=cuda)[1:].view(4, 6, 6, 64).permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="16 bytes"):
        wbn.launch_kernel_forward(off, *args[1:])
    odd = torch.zeros(4, 6, 6, 66, device=cuda).permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="multiple of 4"):
        wbn.launch_kernel_forward(odd, *args[1:])
    assert wbn.launch_counts["kernel"] == before + 6


@pytest.mark.cuda
def test_the_kernels_hold_no_atomic(cuda):
    """No atomic or reduction-to-memory instruction in the compiled kernels
    (``cuobjdump -sass`` of the library), and no aten op of
    ``ATOMIC_ATEN_OPS`` or flagged by PyTorch's deterministic mode around
    them."""
    from pd_fusion_torch.ops.attention_pool import _nvcc, build_library
    from pd_fusion_torch.utils import determinism_checks as dc

    tool = shutil.which("cuobjdump") or str(Path(_nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([tool, "-sass", str(build_library(wbn.SOURCE))], capture_output=True,
                          text=True, check=True).stdout
    assert "wbn_stats_kernel" in sass and "wbn_bwd_apply_kernel" in sass
    assert not re.findall(r"\b(?:ATOMS?|ATOMG|RED)\b[.\w]*", sass)
    inp = wc.bn_inputs((8, 64, 7, 7), True, 0, cuda)
    gy = wc.bn_inputs((8, 64, 7, 7), False, 1, cuda)["x"]
    fn = lambda: wc._run(inp, True, gy)  # noqa: E731
    assert not (dc.aten_ops_called(fn) & dc.ATOMIC_ATEN_OPS)
    assert not dc.flagged_ops(fn)


@pytest.mark.cuda
def test_two_unfrozen_resnet50_steps_from_one_state_are_equal(cuda):
    """The unfrozen ResNet-50 step at the config's width (B=4 bags of 64
    slices 160^2 -> 224^2), twice from one state: equal bit for bit, each
    through the kernels alone (106 calls: 53 forward, 53 backward)."""
    from pd_fusion_torch.utils import determinism_checks as dc

    prog = next(p for p in dc.ft_step_programs(cuda, small=False) if p.name == "ft_step_unfrozen")
    before = dict(wbn.launch_counts)
    profiling.reset()
    with profiling.tracing():
        twice = dc.run_twice(prog.fn, prog.make_state)
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    assert all(eq for eq, _ in twice.values()), [k for k, (eq, _) in twice.items() if not eq]
    assert wbn.launch_counts["plain"] == before["plain"]
    assert counters.get("backbone:bn_kernel") == 2 * 106 and "backbone:bn_plain" not in counters


# the peak device memory of one unfrozen full-width step (the config's B=4
# bags of L=64 slices 160^2 -> 224^2, 256 images) with every activation kept
# for the backward pass: 22.84 and 6.74 GB on an H100 80GB HBM3, plus a tenth
PEAK_GB = {"resnet50": 25.0, "resnet18": 7.4}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(PEAK_GB))
def test_an_unfrozen_full_width_step_peaks_under_its_bound(cuda, arch):
    """The memory a training forward keeps for the backward pass: one
    unfrozen ``ft_step`` at the config's width peaks under its bound (and
    ResNet-50's under 40 GB, half the card), through the kernels alone (3
    launches a call, 53 or 20 BNs forward and backward)."""
    from pd_fusion_torch.utils.determinism_checks import FT_BAGS

    bp, hp, opt, batch, hyper = _step_args(arch, cuda,
                                           fc.step_inputs(*FT_BAGS, seed=3, ragged=False))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    wbn.reset_launch_counts()
    _, _, loss = ft.ft_step(bp, hp, opt, batch, 1.0, hyper)
    assert np.isfinite(float(loss))
    peak = torch.cuda.max_memory_allocated(cuda) / 1e9
    bns = 53 if arch == "resnet50" else 20
    assert wbn.launch_counts == {"kernel": 3 * 2 * bns, "plain": 0}
    assert peak < min(PEAK_GB[arch], 40.0), f"{arch}: peak {peak:.3f} GB"
