"""The ResNet's convolution gradients in the port's own form
(``pd_fusion_torch/nn/resnet.py::_Conv2d``: weight gradients as products of
the output gradient with the input's windows, data gradients as products or
forward convolutions, strided ones split by phase) against
``torch.autograd.grad`` of ``F.conv2d`` on the same inputs, made from a
numpy seed: every kind the two architectures reach, odd and non-square
sizes, NCHW and channels-last, float64 (1e-10 of the largest magnitude) and
float32 (1e-5). Then whole ResNet-18 and ResNet-50 train-mode passes
against the same passes through ``F.conv2d``'s autograd
(``nn/resnet_checks.py::cudnn_backward``), and the census of the
convolutions a 224^2 pass runs.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pd_fusion_torch.nn import resnet as R
from pd_fusion_torch.nn import resnet_checks as rc
from test_torch_port_jax_draws import one_cpu_thread

REL = {torch.float64: 1e-10, torch.float32: 1e-5}
# (kernel, stride, padding, c_in, c_out): the stem, the bottleneck's and the
# downsample's 1x1 at stride 1 and 2, the 3x3 at stride 1 and 2
KINDS = {"stem_7x7_s2": (7, 2, 3, 3, 8), "1x1_s1": (1, 1, 0, 8, 16), "1x1_s2": (1, 2, 0, 8, 16),
         "3x3_s1": (3, 1, 1, 8, 8), "3x3_s2": (3, 2, 1, 8, 12)}
# a 3x3 wide enough (512 -> 512, layer4's) that the weight gradient is one
# product, not a sum of per-group products (nn/resnet.py::_outer_sum)
WIDE = (3, 1, 1, 512, 512)
SIZES = [(8, 8), (7, 7), (9, 10)]
DTYPES = pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
LAYOUTS = pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "channels_last"])


def _close(got, want, rel, what):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * scale, f"{what}: {err:.3e} of {scale:.3e}"


def _inputs(spec, hw, channels_last, dtype, seed=0, n=3):
    k, s, p, cin, cout = spec
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, cin, *hw))).to(dtype)
    w = torch.from_numpy(rng.standard_normal((cout, cin, k, k)) / np.sqrt(cin * k * k)).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    ho, wo = ((d + 2 * p - k) // s + 1 for d in hw)
    g = torch.from_numpy(rng.standard_normal((n, cout, ho, wo))).to(dtype)
    return x, w, g, s, p


def _check_against_autograd(spec, hw, channels_last, dtype):
    x, w, g, s, p = _inputs(spec, hw, channels_last, dtype)
    x.requires_grad_(True)
    w.requires_grad_(True)
    want = torch.autograd.grad(F.conv2d(x, w, stride=s, padding=p), (x, w), g)
    got = torch.autograd.grad(R._Conv2d.apply(x, w, None, s, p), (x, w), g)
    for a, b, what in zip(got, want, ("data gradient", "weight gradient")):
        assert a.shape == b.shape and a.dtype == dtype
        _close(a, b, REL[dtype], what)


@DTYPES
@LAYOUTS
@pytest.mark.parametrize("hw", SIZES, ids=["8x8", "7x7", "9x10"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_own_gradients_match_autograd_of_conv2d(kind, hw, channels_last, dtype):
    _check_against_autograd(KINDS[kind], hw, channels_last, dtype)


@DTYPES
@LAYOUTS
def test_own_gradients_of_a_wide_conv_match_autograd(channels_last, dtype):
    _check_against_autograd(WIDE, (7, 7), channels_last, dtype)


def test_bias_gradient_matches_autograd():
    x, w, g, s, p = _inputs(KINDS["3x3_s2"], (9, 10), True, torch.float64)
    b = torch.linspace(-1.0, 1.0, w.shape[0], dtype=torch.float64)
    for t in (x, w, b):
        t.requires_grad_(True)
    want = torch.autograd.grad(F.conv2d(x, w, b, stride=s, padding=p), (x, w, b), g)
    got = torch.autograd.grad(R._Conv2d.apply(x, w, b, s, p), (x, w, b), g)
    for a, c in zip(got, want):
        _close(a, c, REL[torch.float64], "gradient")


@pytest.mark.parametrize("input_grad", [False, True], ids=["input_frozen", "input_grad"])
def test_stem_skips_the_input_gradient_unless_asked(monkeypatch, input_grad):
    """The fine-tune's stem input (the augmented slices) needs no gradient:
    the Function computes none then; asked for it (as
    ``tests/test_torch_port_resnet.py`` asks), it computes it right."""
    x, w, g, s, p = _inputs(KINDS["stem_7x7_s2"], (16, 16), True, torch.float64)
    calls = []
    data_grad = R._data_grad
    monkeypatch.setattr(R, "_data_grad", lambda *a: calls.append(1) or data_grad(*a))
    x.requires_grad_(input_grad)
    w.requires_grad_(True)
    leaves = (x, w) if input_grad else (w,)
    got = torch.autograd.grad(R._conv(x, w, stride=s, padding=p), leaves, g)
    want = torch.autograd.grad(F.conv2d(x, w, stride=s, padding=p), leaves, g)
    assert len(calls) == int(input_grad)
    for a, b in zip(got, want):
        _close(a, b, REL[torch.float64], "stem gradient")


def test_conv_dispatches_the_function_only_under_autograd():
    x, w, _, s, p = _inputs(KINDS["3x3_s1"], (8, 8), True, torch.float32)
    assert R._conv(x, w, stride=s, padding=p).grad_fn is None
    w.requires_grad_(True)
    assert type(R._conv(x, w, stride=s, padding=p).grad_fn).__name__ == "_Conv2dBackward"
    with torch.no_grad():
        assert R._conv(x, w, stride=s, padding=p).grad_fn is None


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_train_gradients_match_the_plain_autograd_version(arch):
    """Every trainable leaf's and the input's gradient through
    ``resnet_apply_train`` at 64^2 (3 images, the last at sample weight
    0), float64."""
    with one_cpu_thread():
        got = rc.backbone_grads(arch, plain=False)
        want = rc.backbone_grads(arch, plain=True)
    assert list(got) == list(want) and len(got) > 20
    for name, a in got.items():
        _close(a, want[name], REL[torch.float64], name)


def test_the_census_of_a_224_pass():
    """ResNet-50 at 224^2 runs 53 convolutions of 23 shapes; ResNet-18 20
    of 11: every one of a kind ``_Conv2d`` covers, the stem's input 3
    channels."""
    for arch, n, distinct in (("resnet50", 53, 23), ("resnet18", 20, 11)):
        calls = rc.conv_calls(arch, 224)
        assert sum(calls.values()) == n and len(calls) == distinct
        kinds = {rc.kind(w, s) for (_, w, s, _) in calls}
        assert kinds == set(rc.KINDS.values()) - ({"1x1/1"} if arch == "resnet18" else set())
        stem = next(iter(calls))
        assert stem[0][0] == 3 and stem[1][2:] == (7, 7)


def test_backward_forms_hold_the_port_to_cudnn_and_float64(monkeypatch):
    """``chip_smoke.py`` phase 39(c)'s table on the CPU at a small size
    (the CPU's ``aten.convolution_backward`` in place of cuDNN's; no
    timing): every ResNet-50 convolution's gradients equal twice in the
    port's form and no further from float64 than the library's."""
    monkeypatch.setattr(rc, "_event_ms", lambda fn, reps: (fn(), 1.0)[1])
    with one_cpu_thread():
        rows = rc.backward_forms(2, "resnet50", 32, "cpu", reps=1, rounds=1)
    assert len(rows) == 23 and [r["input_grad"] for r in rows].count(False) == 1
    assert max(r["rel_err"] for r in rows) < 1e-5
    kinds = rc.by_kind(rows)
    assert sum(k["convs"] for k in kinds.values()) == 53
    assert all(k["own_ms"] == k["convs"] for k in kinds.values())
