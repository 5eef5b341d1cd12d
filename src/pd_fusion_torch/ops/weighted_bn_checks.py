"""The fused train-mode BN (``ops/weighted_bn.py``) against its plain
PyTorch version: the one copy of the checks that
``tests/test_torch_port_bn_fused.py`` runs on the CPU and on the card.

- ``bn_calls(arch, size, n)``: every BN of one train-mode forward of ``n``
  images at ``size``^2, with what follows it (residual add, ReLU) and its
  count (traced on the meta device: no data, no time);
- ``plain_everywhere()``: inside the block the fused BN takes its plain
  version on the card too (the kernels take float32 alone; the float64
  references of ``nn/resnet_checks.py`` run on the card): an instrument of
  the checks, used by no entry point;
- ``bn_inputs(...)``: seeded inputs of one call, x in channels-last memory
  as the backbone hands it over;
- ``check_call(...)``: one forward and one backward through ``WeightedBN``
  (the kernels on a CUDA tensor) against the plain version, both held to
  the plain version in float64: the call's error may not pass
  ``ERROR_FACTOR`` times the float32 plain version's, or ``ERROR_FLOOR`` of
  each output's largest magnitude, whichever is larger (float32 sums taken
  in another order: the kernels add in float64 across tiles and in float32
  within a thread's rows, the plain version as PyTorch's reductions do);
  under the ReLU each side's gradients are held to the float64 backward
  through that side's own mask (``y > 0``): an output within rounding of
  0 falls on either side of it by chance in float32, and such a flip
  moves one gradient element by its whole size, an error of the forward's
  rounding, not of the backward; a second call gives the same bits;
- ``time_calls(...)``: the forward and the backward of each distinct BN of
  a step, kernels, plain version and ``F.batch_norm`` (unweighted: the
  library's yardstick, which the port never calls), between CUDA events,
  with the bytes bound at 3.35 TB/s.
"""
import contextlib
import statistics
from collections import Counter
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from pd_fusion_torch.ops import weighted_bn as wbn

EPS = 1e-5
MOMENTUM = 0.1
ERROR_FACTOR = 4.0
ERROR_FLOOR = 1e-5
HBM_BYTES_PER_S = 3.35e12

Call = Tuple[Tuple[int, int, int, int], bool, bool]  # ([N, C, H, W], residual, relu)


def bn_calls(arch: str = "resnet50", size: int = 224, n: int = 256) -> Dict[Call, int]:
    """Every BN of one ``resnet_apply_train`` forward -> {call: count}, in
    the order they first run."""
    from pd_fusion_torch.nn import resnet as R

    calls: Counter = Counter()

    def record(y, p, identity=None, relu=False):
        calls[(tuple(y.shape), identity is not None, relu)] += 1
        return (y + identity if identity is not None else y), p

    params = R.params_to(R.init_resnet(torch.Generator().manual_seed(0), arch), device="meta")
    x = torch.empty(n, size, size, 3, device="meta")
    with torch.no_grad():
        R._forward(params, R._nchw(x), arch, record)
    return dict(calls)


@contextlib.contextmanager
def plain_everywhere():
    """The fused BN's kernel wrappers replaced by the plain version inside
    the block (same signatures), on every device."""
    saved = wbn.launch_kernel_forward, wbn.launch_kernel_backward
    wbn.launch_kernel_forward, wbn.launch_kernel_backward = wbn.forward_plain, wbn.backward_plain
    try:
        yield
    finally:
        wbn.launch_kernel_forward, wbn.launch_kernel_backward = saved


def bn_inputs(shape, residual: bool, seed: int, device, dtype=torch.float32, weighted=True):
    """x (channels-last, a conv output's scale and offset per channel),
    gamma, beta, running statistics, identity (or None) and image weights
    with every fourth image at 0 (or None)."""
    N, C, H, W = shape
    g = torch.Generator().manual_seed(seed)

    def rand(*s):
        return torch.randn(*s, generator=g, dtype=torch.float64)

    x = (rand(N, H, W, C) * (0.5 + rand(C).abs()) + rand(C)).permute(0, 3, 1, 2)
    out = {"x": x, "gamma": 1.0 + 0.2 * rand(C), "beta": 0.1 * rand(C),
           "running_mean": 0.1 * rand(C), "running_var": 1.0 + 0.1 * rand(C).abs(),
           "identity": rand(N, H, W, C).permute(0, 3, 1, 2) if residual else None,
           "w": ((torch.arange(N) % 4) != 3).double() if weighted else None}
    return {k: None if v is None else v.to(device=device, dtype=dtype) for k, v in out.items()}


def _run(inp, relu: bool, gy):
    """One forward and backward through ``WeightedBN`` -> every output."""
    x = inp["x"].detach().requires_grad_(True)
    gamma = inp["gamma"].detach().requires_grad_(True)
    beta = inp["beta"].detach().requires_grad_(True)
    identity = inp["identity"]
    leaves = [x, gamma, beta]
    if identity is not None:
        identity = identity.detach().requires_grad_(True)
        leaves.append(identity)
    y, new_mean, new_var = wbn.WeightedBN.apply(x, gamma, beta, identity, inp["w"],
                                                inp["running_mean"], inp["running_var"],
                                                MOMENTUM, EPS, relu)
    grads = torch.autograd.grad(y, leaves, gy)
    names = ["y", "new_mean", "new_var", "dx", "dgamma", "dbeta", "didentity"]
    return dict(zip(names, [t.detach() for t in (y, new_mean, new_var, *grads)]))


def _rel(a, b) -> float:
    return float((a.double() - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def check_call(shape, residual: bool, relu: bool, device, seed: int = 0, weighted=True) -> Dict:
    """``WeightedBN`` on ``device`` (the kernels on a card) against float64,
    beside the float32 plain version, each side's gradients through its own
    ReLU mask; twice, equal bit for bit. -> {output: (error, the plain
    version's error)}. Raises past the limits."""
    inp = bn_inputs(shape, residual, seed, device, weighted=weighted)
    gy = bn_inputs(shape, False, seed + 1, device)["x"]
    before = dict(wbn.launch_counts)
    got = _run(inp, relu, gy)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()  # a fault in the launches shows here
    used = {k: wbn.launch_counts[k] - before[k] for k in before}
    if on_card and used != {"kernel": 6, "plain": 0}:
        raise AssertionError(f"expected the kernels alone, 3 launches each way: {used}")
    again = _run(inp, relu, gy)
    if on_card:
        torch.cuda.synchronize()
    unequal = [k for k in got if not torch.equal(got[k], again[k])]
    if unequal:
        raise AssertionError(f"{shape}: two calls differ in {unequal}")
    del again
    plain = _plain(inp, relu, gy, torch.float32)
    errs = {k: [0.0, 0.0] for k in got}
    for i, side in enumerate((got, plain)):
        exact = _plain(inp, relu, gy, torch.float64, side["y"] if relu else None)
        for k, want in exact.items():
            errs[k][i] = _rel(side[k], want)
        del exact
    out = {}
    for k, (err, err_plain) in errs.items():
        out[k] = (err, err_plain)
        if err > max(ERROR_FACTOR * err_plain, ERROR_FLOOR):
            raise AssertionError(f"{shape} residual={residual} relu={relu}: {k} {err:.3e} off "
                                 f"float64, the plain float32 version {err_plain:.3e}")
    return out


def _plain(inp, relu, gy, dtype, mask_y=None):
    """The plain version's every output, on the inputs' device, in
    ``dtype``, as float64; under the ReLU the backward takes its mask from
    ``mask_y > 0`` if given, else from its own output."""
    inp = {k: None if v is None else v.to(dtype) for k, v in inp.items()}
    y, stats, new_mean, new_var = wbn.forward_plain(
        inp["x"], inp["gamma"], inp["beta"], inp["w"], inp["identity"], relu,
        inp["running_mean"], inp["running_var"], MOMENTUM, EPS)
    gate = y if mask_y is None else mask_y.to(dtype)
    dx, dgamma, dbeta, did = wbn.backward_plain(gy.to(dtype), inp["x"], gate, stats, inp["gamma"],
                                                inp["w"], relu, inp["identity"] is not None)
    out = {"y": y, "new_mean": new_mean, "new_var": new_var, "dx": dx, "dgamma": dgamma,
           "dbeta": dbeta}
    if did is not None:
        out["didentity"] = did
    return {k: v.double() for k, v in out.items()}


def _event_ms(fn, reps: int) -> float:
    """Median of ``reps`` calls, each between its own CUDA events."""
    fn()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    for s, e in pairs:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bytes_bound(shape, residual: bool, relu: bool) -> Tuple[int, int]:
    """The least bytes (forward, backward): each tensor read or written
    once. Forward: x, the identity, y; backward: gy, x, y under the ReLU,
    dx, and the identity's gradient."""
    t = 4 * shape[0] * shape[1] * shape[2] * shape[3]
    return t * (2 + residual), t * (3 + relu + residual)


def time_calls(arch: str = "resnet50", n: int = 256, size: int = 224, reps: int = 10) -> List[Dict]:
    """Each distinct BN of a ``resnet_apply_train`` step on the card: the
    forward and the backward of the kernels, of the plain version
    (``forward_plain`` and ``backward_plain`` on the card) and of
    ``F.batch_norm`` (training, unweighted) with the add and ReLU in torch
    ops, each the median of ``reps`` between CUDA events. -> one record a
    call (ms)."""
    rows = []
    for (shape, residual, relu), count in bn_calls(arch, size, n).items():
        inp = bn_inputs(shape, residual, 0, "cuda")
        gy = bn_inputs(shape, False, 1, "cuda")["x"]
        args = (inp["x"], inp["gamma"], inp["beta"], inp["w"], inp["identity"], relu,
                inp["running_mean"], inp["running_var"], MOMENTUM, EPS)
        y, stats, _, _ = wbn.launch_kernel_forward(*args)
        bwd = (gy, inp["x"], y, stats, inp["gamma"], inp["w"], relu, residual)

        def library():
            out = F.batch_norm(inp["x"], inp["running_mean"].clone(), inp["running_var"].clone(),
                               inp["gamma"], inp["beta"], True, MOMENTUM, EPS)
            if residual:
                out = out + inp["identity"]
            return torch.relu(out) if relu else out

        xl = inp["x"].detach().requires_grad_(True)
        gl = inp["gamma"].detach().requires_grad_(True)
        bl = inp["beta"].detach().requires_grad_(True)
        out = F.batch_norm(xl, None, None, gl, bl, True, MOMENTUM, EPS)
        out = torch.relu(out + inp["identity"] if residual else out) if relu else \
            (out + inp["identity"] if residual else out)
        fwd_b, bwd_b = bytes_bound(shape, residual, relu)
        rows.append({
            "shape": list(shape), "residual": residual, "relu": relu, "count": count,
            "kernel_fwd_ms": _event_ms(lambda: wbn.launch_kernel_forward(*args), reps),
            "kernel_bwd_ms": _event_ms(lambda: wbn.launch_kernel_backward(*bwd), reps),
            "plain_fwd_ms": _event_ms(lambda: wbn.forward_plain(*args), reps),
            "plain_bwd_ms": _event_ms(lambda: wbn.backward_plain(*bwd), reps),
            "library_fwd_ms": _event_ms(library, reps),
            "library_bwd_ms": _event_ms(
                lambda: torch.autograd.grad(out, (xl, gl, bl), gy, retain_graph=True), reps),
            "bound_fwd_ms": 1e3 * fwd_b / HBM_BYTES_PER_S,
            "bound_bwd_ms": 1e3 * bwd_b / HBM_BYTES_PER_S,
        })
        del inp, gy, y, stats, bwd, xl, gl, bl, out
    return rows
