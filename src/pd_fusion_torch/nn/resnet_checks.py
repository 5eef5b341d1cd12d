"""The ResNet's convolution gradients in the port's own form
(``nn/resnet.py::_Conv2d``) against cuDNN's backward, for ``chip_smoke.py``,
the ``cuda``-marked tests and the CPU tests.

- ``conv_calls(arch, size)``: every convolution of a train-mode forward at
  ``size``^2 with its count (traced on the meta device: no data, no
  time), each of the kinds of ``KINDS``;
- ``cudnn_backward()``: inside the block the ResNet's convolutions take
  ``F.conv2d``'s own autograd (on the card, cuDNN's backward kernels, which
  add with float atomics): the form ``_Conv2d`` replaced, kept to compare
  and time against, used by no entry point;
- ``cudnn_deterministic()``: cuDNN limited to its deterministic
  algorithms inside the block (an instrument of the checks only);
- ``backbone_grads(...)``: a train-mode pass's gradients, in either form;
- ``backward_forms(...)``: each convolution's gradients at the fine-tune
  step's width (N = B * L images) in three forms, the port's own,
  cuDNN's default backward (``aten.convolution_backward``) and the same
  under ``cudnn_deterministic``, each timed between CUDA events in turns;
  the port's form twice (equal bit for bit), and both forms against the
  port's form in float64.
"""
import contextlib
import statistics
from collections import Counter
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from pd_fusion_torch.nn import resnet as R
from pd_fusion_torch.ops import weighted_bn_checks as wbc

# (kernel size, stride) -> the kind's name in PERF.md's table
KINDS = {(7, 2): "7x7/2 stem", (1, 1): "1x1/1", (1, 2): "1x1/2", (3, 1): "3x3/1",
         (3, 2): "3x3/2"}
# at the fine-tune width a weight gradient sums up to 802,816 float32 terms
# (layer1: 256 images x 56^2), so two orders of the sum differ by about
# 1e-4 of its largest magnitude: each form is held to the port's form in
# float64, and the port's float32 error may be at most ACCURACY_FACTOR
# times cuDNN's (or under ACCURACY_FLOOR)
ACCURACY_FACTOR = 2.0
ACCURACY_FLOOR = 1e-5

# (the input's [C, H, W], the weight's shape, stride, padding)
Conv = Tuple[Tuple[int, ...], Tuple[int, ...], int, int]


def kind(w_shape, stride) -> str:
    return KINDS[(w_shape[2], stride)]


def _plain_conv(x, w, b=None, stride=1, padding=None):
    if padding is None:
        padding = w.shape[2] // 2
    return F.conv2d(x.to(w.dtype), w, b, stride=stride, padding=padding)


@contextlib.contextmanager
def _patched(module, name, value):
    before = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, before)


def cudnn_backward():
    """The ResNet's convolutions through ``F.conv2d``'s autograd inside the
    block (cuDNN's backward kernels on the card)."""
    return _patched(R, "_conv", _plain_conv)


def cudnn_deterministic():
    """cuDNN limited to its deterministic algorithms inside the block."""
    return _patched(torch.backends.cudnn, "deterministic", True)


def conv_calls(arch: str = "resnet50", size: int = 224) -> Dict[Conv, int]:
    """Every convolution of one train-mode forward of one image at
    ``size``^2 -> {(x [C, H, W], w shape, stride, padding): count}, in the
    order they first run."""
    calls: Counter = Counter()

    def record(x, w, b=None, stride=1, padding=None):
        padding = w.shape[2] // 2 if padding is None else padding
        calls[(tuple(x.shape[1:]), tuple(w.shape), stride, padding)] += 1
        return _plain_conv(x, w, b, stride, padding)

    params = R.params_to(R.init_resnet(torch.Generator().manual_seed(0), arch), device="meta")
    with _patched(R, "_conv", record), torch.no_grad():
        R.resnet_apply(params, torch.empty(1, size, size, 3, device="meta"), arch, train=True)
    return dict(calls)


def conv_inputs(conv: Conv, n: int, device):
    """Seeded float32 (x, w, g) for one convolution of ``conv_calls`` at
    batch ``n``: channels-last input and output gradient, as the train
    step has them."""
    (c, h, w_), w_shape, stride, padding = conv
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(n, h, w_, c, generator=gen, device=device).permute(0, 3, 1, 2)
    w = torch.randn(w_shape, generator=gen, device=device) * (
        2.0 / (w_shape[0] * w_shape[2] * w_shape[3])) ** 0.5
    ho = (h + 2 * padding - w_shape[2]) // stride + 1
    wo = (w_ + 2 * padding - w_shape[3]) // stride + 1
    g = torch.randn(n, ho, wo, w_shape[0], generator=gen, device=device).permute(0, 3, 1, 2)
    return x, w, g


def own_grads(x, w, g, stride, padding, input_grad=True):
    return R.conv2d_grads(g, x, w, stride, padding, (input_grad, True, False))[:2]


def cudnn_grads(x, w, g, stride, padding, input_grad=True):
    """``aten.convolution_backward`` as ``F.conv2d``'s autograd calls it."""
    gx, gw, _ = torch.ops.aten.convolution_backward(
        g, x, w, None, [stride] * 2, [padding] * 2, [1, 1], False, [0, 0], 1,
        [input_grad, True, False])
    return gx, gw


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def backbone_grads(arch: str, plain: bool, device="cpu") -> Dict[str, torch.Tensor]:
    """Float64 gradients of a weighted sum of ``resnet_apply_train``'s
    embeddings (a seeded init, 3 seeded images at 64^2, the last at sample
    weight 0) with respect to every trainable leaf and the input
    (``"x"``); ``plain``: through ``F.conv2d``'s autograd
    (``cudnn_backward``), else the port's. Both forms take the fused BN's
    plain version (``weighted_bn_checks.plain_everywhere``: its kernels
    take float32 alone). -> {leaf path: gradient}."""
    f64 = torch.float64
    params = R.params_to(R.init_resnet(torch.Generator().manual_seed(3), arch), device=device,
                         dtype=f64)
    wrt = {k: t.requires_grad_(True) for k, t in _leaves(params)
           if k.rsplit("/", 1)[-1] not in R.BN_STATS}
    gen = torch.Generator().manual_seed(4)
    wrt["x"] = torch.rand(3, 64, 64, 3, generator=gen, dtype=f64).to(device).requires_grad_()
    coef = torch.linspace(-1.0, 1.0, R.emb_dim(arch), dtype=f64, device=device)
    weight = torch.tensor([1.0, 1.0, 0.0], dtype=f64, device=device)
    with cudnn_backward() if plain else contextlib.nullcontext(), wbc.plain_everywhere():
        emb, _ = R.resnet_apply_train(params, wrt["x"], arch, sample_weight=weight)
        grads = torch.autograd.grad(torch.sum(emb * coef), list(wrt.values()))
    return dict(zip(wrt, grads))


def _rel(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _event_ms(fn, reps) -> float:
    """Median of ``reps`` calls, each between its own CUDA events."""
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    for s, e in pairs:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


FORMS = {"own": (own_grads, contextlib.nullcontext),
         "cudnn_default": (cudnn_grads, contextlib.nullcontext),
         "cudnn_deterministic": (cudnn_grads, cudnn_deterministic)}


def backward_forms(n: int, arch: str = "resnet50", size: int = 224, device="cuda",
                   reps: int = 5, rounds: int = 2) -> List[Dict]:
    """Each distinct convolution of ``conv_calls(arch, size)`` at batch
    ``n``: its gradients in ``FORMS``, in turns (``rounds`` blocks of
    ``reps`` calls each, order reversed every other block), each block's
    median between CUDA events; the port's form run twice (equal bit for
    bit), and it and cuDNN's default held to the port's form in float64
    (``ACCURACY_FACTOR``). The stem's input gradient is left out, as the
    fine-tune step needs none. -> one record a convolution (times in
    ms)."""
    rows = []
    for conv, count in conv_calls(arch, size).items():
        (c, h, w_), w_shape, stride, padding = conv
        x, w, g = conv_inputs(conv, n, device)
        input_grad = c != 3
        own = own_grads(x, w, g, stride, padding, input_grad)
        again = own_grads(x, w, g, stride, padding, input_grad)
        cudnn = cudnn_grads(x, w, g, stride, padding, input_grad)
        exact = own_grads(x.double(), w.double(), g.double(), stride, padding, input_grad)
        equal = all(torch.equal(a, b) for a, b in zip(own, again) if a is not None)
        err, err_cudnn = (max(_rel(a, b) for a, b in zip(form, exact) if a is not None)
                          for form in (own, cudnn))
        if not equal or err > max(ACCURACY_FACTOR * err_cudnn, ACCURACY_FLOOR):
            raise AssertionError(f"{conv}: the port's gradients equal twice {equal}, "
                                 f"{err:.3e} off float64, cuDNN's {err_cudnn:.3e}")
        del own, again, cudnn, exact
        times = {name: [] for name in FORMS}
        order = list(FORMS)
        for r in range(rounds):
            for name in order if r % 2 == 0 else order[::-1]:
                fn, ctx = FORMS[name]
                with ctx():
                    fn(x, w, g, stride, padding, input_grad)  # warm-up (algorithm choice)
                    times[name].append(_event_ms(
                        lambda: fn(x, w, g, stride, padding, input_grad), reps))  # noqa: B023
        rows.append({"kind": kind(w_shape, stride), "x": [n, c, h, w_], "w": list(w_shape),
                     "stride": stride, "count": count, "input_grad": input_grad,
                     "rel_err": err, "rel_err_cudnn": err_cudnn,
                     **{f"{name}_ms": statistics.median(t) for name, t in times.items()}})
        del x, w, g
    return rows


def by_kind(rows: List[Dict]) -> Dict[str, Dict[str, float]]:
    """``backward_forms``' rows summed by kind, each convolution times its
    count in one step -> {kind: {form: ms a step, "convs": count}}."""
    out: Dict[str, Dict[str, float]] = {}
    for r in rows:
        k = out.setdefault(r["kind"], {"convs": 0, **{f"{f}_ms": 0.0 for f in FORMS}})
        k["convs"] += r["count"]
        for f in FORMS:
            k[f"{f}_ms"] += r["count"] * r[f"{f}_ms"]
    return out
