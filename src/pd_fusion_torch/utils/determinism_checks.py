"""Run-to-run determinism of the port's device programs, for
``chip_smoke.py`` (phase 39) and the tests.

The JAX package gives the same bits on every run of one config: XLA's
reductions run in a fixed order. A CUDA op that accumulates with float
atomics does not: the order in which the threads' adds land changes from
run to run, and so may the last bits of a sum that is not integer-valued.
Three instruments:

- ``run_twice(fn, make_state)``: ``fn`` twice from identical inputs and
  state (``make_state`` rebuilds params, optimizer state and generators
  for each run) -> for each output leaf, (equal bit for bit, largest
  absolute gap);
- ``flagged_ops(fn)``: the ops PyTorch warns about when ``fn`` runs once
  under ``torch.use_deterministic_algorithms(True, warn_only=True)`` (the
  mode is restored afterwards; no entry point of the package turns it on:
  it is an instrument of the checks only). It finds library ops with no
  deterministic CUDA form; an op it flags may still give equal runs (a
  pool whose windows do not overlap writes each element once);
- ``aten_ops_called(fn)``: the aten ops ``fn`` dispatches, recorded by a
  ``TorchDispatchMode``. It works on the CPU, so the tests can hold a
  program to calling no op of ``ATOMIC_ATEN_OPS`` without a card.

``programs(device, size)`` builds every device program of the port's
paths at the width its ``chip_smoke.py`` phase uses (``size="small"``
for a rehearsal on the CPU), and ``audit`` runs each twice and once
under the deterministic mode.
"""
import inspect
import time
import warnings
from collections import namedtuple
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

# aten ops whose CUDA implementation adds floats with atomics (in no fixed
# order). The backwards of ``gather`` and ``index_select`` reach the
# dispatcher as ``scatter_add`` and ``index_add``; the qualified names are
# the op with the argument that makes it accumulate.
ATOMIC_ATEN_OPS = frozenset({
    "scatter_add", "index_add", "index_put(accumulate)", "put(accumulate)",
    "bincount(weights)", "histc", "scatter_reduce(sum)", "scatter_reduce(mean)", "scatter(add)",
    "max_pool3d_with_indices_backward", "grid_sampler_2d_backward",
    "upsample_bilinear2d_backward",
})

ROOT = Path(__file__).resolve().parents[3]


def _arg(args, kwargs, i, key, default=None):
    return kwargs[key] if key in kwargs else (args[i] if len(args) > i else default)


def op_name(func, args, kwargs) -> str:
    """An aten op's name as ``ATOMIC_ATEN_OPS`` spells it: in-place and
    out forms folded into the op, accumulating forms qualified."""
    name = func.overloadpacket.__name__.rstrip("_")
    if name in ("index_put", "_index_put_impl", "_unsafe_index_put"):
        return "index_put(accumulate)" if _arg(args, kwargs, 3, "accumulate", False) \
            else "index_put"
    if name == "put":
        return "put(accumulate)" if _arg(args, kwargs, 3, "accumulate", False) else "put"
    if name == "bincount":
        return "bincount(weights)" if _arg(args, kwargs, 1, "weights") is not None \
            else "bincount"
    if name == "scatter_reduce":
        return f"scatter_reduce({_arg(args, kwargs, 4, 'reduce')})"
    if name == "scatter" and kwargs.get("reduce") in ("add", "sum"):
        return "scatter(add)"
    return name


def aten_ops_called(fn: Callable[[], object]) -> set:
    """The names (``op_name``) of the aten ops ``fn()`` dispatches, its
    backward passes included."""
    from torch.utils._python_dispatch import TorchDispatchMode

    names = set()

    class Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            names.add(op_name(func, args, kwargs))
            return func(*args, **kwargs)

    with Recorder():
        fn()
    return names


def atomic_ops_called(fn: Callable[[], object]) -> List[str]:
    return sorted(aten_ops_called(fn) & ATOMIC_ATEN_OPS)


_NOT_DETERMINISTIC = " does not have a deterministic implementation"


def _flag_name(message: str) -> Optional[str]:
    if _NOT_DETERMINISTIC in message:
        return message.split(_NOT_DETERMINISTIC)[0].strip()
    if "CuBLAS" in message and "deterministic" in message:
        return "cuBLAS (CUBLAS_WORKSPACE_CONFIG unset)"
    return None


def flagged_ops(fn: Callable[[], object]) -> List[str]:
    """The ops PyTorch flags as nondeterministic while ``fn()`` runs once
    under ``torch.use_deterministic_algorithms(True, warn_only=True)``;
    the previous mode is restored."""
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
    return sorted({n for n in (_flag_name(str(w.message)) for w in caught) if n})


def output_leaves(tree, prefix="") -> Iterator[Tuple[str, np.ndarray]]:
    """(path, numpy array) of every leaf of nested dicts, lists and tuples
    of tensors, arrays and scalars (tensors copied to the host)."""
    if isinstance(tree, dict):
        for k in tree:
            yield from output_leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from output_leaves(v, f"{prefix}{i}.")
    elif isinstance(tree, torch.Tensor):  # a copy: a later run may update the tensor in place
        yield prefix.rstrip(".") or "out", tree.detach().cpu().numpy().copy()
    elif tree is not None:
        yield prefix.rstrip(".") or "out", np.array(tree)


def gap(a: np.ndarray, b: np.ndarray) -> float:
    """Largest |a - b| in float64; NaN against NaN is no gap, NaN against a
    number, another shape or unequal non-numbers an infinite one."""
    if a.shape != b.shape:
        return float("inf")
    if a.size == 0:
        return 0.0
    if a.dtype.kind not in "biuf" or b.dtype.kind not in "biuf":
        return 0.0 if np.array_equal(a, b) else float("inf")
    x, y = a.astype(np.float64), b.astype(np.float64)
    both = np.isnan(x) & np.isnan(y)
    d = np.where(both, 0.0, np.abs(x - y))
    return float(np.max(np.where(np.isnan(d), np.inf, d)))


def compare(a, b) -> Dict[str, Tuple[bool, float]]:
    """Two outputs of one program leaf by leaf -> {leaf: (equal bit for
    bit, largest absolute gap)}."""
    la, lb = dict(output_leaves(a)), dict(output_leaves(b))
    if list(la) != list(lb):
        raise ValueError(f"the two outputs hold different leaves: {sorted(set(la) ^ set(lb))}")
    return {k: (_same_bits(la[k], lb[k]), gap(la[k], lb[k])) for k in la}


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.kind == "O":  # Python objects (e.g. the ids of a .npz): their values, not pointers
        return bool(np.array_equal(a, b))
    return a.tobytes() == b.tobytes()


def run_twice(fn: Callable, make_state: Optional[Callable[[], object]] = None
              ) -> Dict[str, Tuple[bool, float]]:
    """``fn(make_state())`` (or ``fn()``) twice, each from a fresh state ->
    {output leaf: (equal bit for bit, largest absolute gap)}."""
    outs = []
    for _ in range(2):
        out = fn(make_state()) if make_state is not None else fn()
        outs.append(dict(output_leaves(out)))  # on the host before the next run
    return compare(*outs)


def _src(obj) -> str:
    """``file:line`` of a function, relative to the repository's root."""
    obj = inspect.unwrap(obj)
    path = Path(inspect.getsourcefile(obj)).resolve()
    try:
        path = path.relative_to(ROOT)
    except ValueError:
        pass
    return f"{path}:{inspect.getsourcelines(obj)[1]}"


def scatter_ece(y_true, y_prob, weights=None, n_bins=10):
    """ECE with its bin sums by ``scatter_add``, the port's earlier form
    (float atomics in no fixed order on a CUDA device): what
    ``ops/metrics.py::expected_calibration_error`` replaced, kept to time
    against it and to plant an atomic op in the tests."""
    from pd_fusion_torch.ops.metrics import _lower_bin_bounds_f32

    w = (torch.ones_like(y_prob) if weights is None else weights.to(y_prob.dtype)).expand_as(
        y_prob)
    bounds = torch.tensor(_lower_bin_bounds_f32(n_bins), device=y_prob.device)
    idx = torch.clamp(torch.sum(y_prob[..., None] > bounds, dim=-1) - 1, 0, n_bins - 1)
    wv = torch.where((y_prob > 0.0) & (y_prob <= 1.0), w, 0.0)
    acc = (y_true.to(y_prob.dtype) == (y_prob >= 0.5).to(y_prob.dtype)).to(y_prob.dtype)
    zeros = torch.zeros(y_prob.shape[:-1] + (n_bins,), dtype=y_prob.dtype, device=y_prob.device)
    bin_w, bin_acc, bin_conf = (zeros.scatter_add(-1, idx, v) for v in (wv, wv * acc, wv * y_prob))
    nonzero = bin_w > 0
    safe = torch.where(nonzero, bin_w, 1.0)
    per_bin = torch.where(nonzero, (bin_w / torch.sum(w, -1, keepdim=True))
                          * torch.abs(bin_acc / safe - bin_conf / safe), 0.0)
    return torch.sum(per_bin, -1)


# ---------------------------------------------------------------------------
# the device programs, each at its chip_smoke.py phase's width
# ---------------------------------------------------------------------------

# a program: ``fn(make_state())`` (or ``fn()`` with no state) returns its
# outputs; ``deterministic``: whether its two runs must be equal (else a
# by-design entry, ``note`` saying why)
Program = namedtuple("Program", "name fn make_state source width deterministic note",
                     defaults=(True, ""))

# configs/model_unimodal.yaml on DeviceHistGBDT's defaults (chip_smoke.py's
# GBDT_HP), fewer rounds: a depth cut
GBDT_HP = dict(depth=5, lr=0.1, lam=0.0, min_child_weight=1e-3, min_child_samples=20.0)
# configs/ppmi_studydata.yaml's mlp
MLP_CFG = {"hidden_dims": [128, 64], "dropout": 0.3, "max_epochs": 100, "lr": 1e-3,
           "patience": 10}
SCATTER_NOTE = ("hist_mode: scatter adds with index_add_ (float atomics); auto takes onehot on "
                "CUDA, only a config that names scatter reaches it")
FT_NOTE = ("cuDNN's backward kernels of the unfrozen ResNet-50 add with atomics; its "
           "deterministic algorithms make the step more than 5% slower (timed in turns in "
           "chip_smoke.py phase 39(c); ROADMAP.md Queue 3)")


def _to(tree, device):
    """A copy of every tensor of ``tree`` on ``device`` (a fresh state)."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device).clone() if isinstance(tree, torch.Tensor) else tree


def _metric_programs(device, small):
    from pd_fusion_torch.analysis.sweep_checks import BOOT_SHAPE, bootstrap_inputs
    from pd_fusion_torch.ops.metrics import (binary_metrics, binary_metrics_packed,
                                             expected_calibration_error)

    n, N = (20, 60) if small else BOOT_SHAPE
    y_r, p_r = (t.to(device) for t in bootstrap_inputs(n, N))
    yield Program(f"ece_{n}x{N}", lambda: expected_calibration_error(y_r, p_r), None,
                  _src(expected_calibration_error), f"[{n}, {N}] (the bootstrap's)")
    yield Program(f"bootstrap_metrics_{n}x{N}", lambda: binary_metrics(y_r, p_r), None,
                  _src(binary_metrics), f"[{n}, {N}], six metrics")
    K, S, nv = (2, 2, 10) if small else (5, 6, 100)
    y, p, w = (t.to(device) for t in bench_frame_inputs(K, S, nv))
    yield Program(f"metrics_packed_K{K}_S{S}_N{nv}", lambda: binary_metrics_packed(p, y, w),
                  None, _src(binary_metrics_packed),
                  f"[{K}, {S}, {nv}] (the bench frame's folds x scenarios x rows)")
    y5, p5, w5 = (t.to(device) for t in ece_inputs(K, K * nv))
    yield Program(f"ece_{K}x{K * nv}", lambda: expected_calibration_error(y5, p5, w5), None,
                  _src(expected_calibration_error), f"[{K}, {K * nv}] (the bench frame's)")


def bench_frame_inputs(K=5, S=6, nv=100, seed=0):
    """Labels, probabilities and weights [K, S, nv] as the CV engine packs
    a fold-batched frame's scenarios (the last fold ragged: weight 0)."""
    rng = np.random.RandomState(seed)
    y = np.broadcast_to((rng.rand(K, 1, nv) < 0.6), (K, S, nv)).astype(np.float32)
    p = rng.rand(K, S, nv).astype(np.float32)
    p[:, :, : nv // 5] = np.round(p[:, :, : nv // 5], 1)  # ties and bin edges
    w = np.ones((K, S, nv), np.float32)
    w[-1, :, -(nv // 10):] = 0.0
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (y, p, w))


def ece_inputs(K=5, N=500, seed=1):
    """[K, N] labels, probabilities (ties, bin edges, zeros) and each
    fold's 0/1 membership as weights."""
    rng = np.random.RandomState(seed)
    y = (rng.rand(K, N) < 0.5).astype(np.float32)
    p = rng.rand(K, N).astype(np.float32)
    p[:, : N // 5] = np.round(p[:, : N // 5], 1)
    p[:, : N // 50] = 0.0
    w = (np.arange(N)[None, :] % K == np.arange(K)[:, None]).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (y, p, w))


def _tabular_programs(device, small):
    from pd_fusion_torch.nn import trainer_checks as tc
    from pd_fusion_torch.nn.trainer import minibatch_moddrop_impl
    from pd_fusion_torch.ops.isotonic import isotonic_fit_transform
    from pd_fusion_torch.ops.isotonic_checks import fold_batched_inputs

    for name, K, epochs in (("tabular_trainer", 5, 10), ("fused_sweep_step", 15, 2)):
        kw = (dict(K=min(K, 3), n=40, hidden=(8, 4), epochs=2, batch_size=8) if small
              else dict(K=K, n=400, hidden=(64, 32), epochs=epochs, batch_size=32))
        inputs = tc.trainer_inputs(**kw)
        width = (f"K={kw['K']}, n={kw['n']}, {list(kw['hidden'])}, batch {kw['batch_size']}, "
                 f"{kw['epochs']} epochs")
        yield Program(f"{name}_K{kw['K']}",
                      lambda t: tc.run_trainer(t, device.type)[:2],  # params, probs: no wall
                      lambda inputs=inputs: _to(inputs, device), _src(minibatch_moddrop_impl),
                      width)

    K, n = (2, 50) if small else (10, 4096)
    iso = fold_batched_inputs(K, n, device=device)
    yield Program(f"isotonic_K{K}_Nc{n}", lambda: isotonic_fit_transform(*iso), None,
                  _src(isotonic_fit_transform), f"K={K}, Nc={n}")

    from pd_fusion_torch.nn.moe import train_moe_folds

    moe = (tc.moe_inputs(K=2, n=40, expert_hidden=(4,), router_hidden=(4,)) if small
           else tc.moe_inputs())
    K, epochs = moe["x"].shape[0], 3 if small else 50
    yield Program(f"moe_trainer_K{K}", lambda t: tc.run_moe(t, device.type, epochs)[:2],
                  lambda: _to(moe, device), _src(train_moe_folds),
                  f"K={K}, experts [32, 16], router [16], {epochs} epochs")


def _gbdt_programs(device, small):
    from pd_fusion_torch.nn import gbdt_checks as gc
    from pd_fusion_torch.nn.gbdt import predict_margin, train_gbdt

    bins, y, w, base = gc.cv_like_inputs(K=2, n=60, f=4) if small else gc.cv_like_inputs()
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    tb, ty, tw, tbase = t(bins), t(y), t(w), t(base)
    rounds = 3 if small else 30
    width = f"K={bins.shape[0]}, n={bins.shape[1]}, F={bins.shape[2]}, {rounds} trees depth 5"
    for mode in ("onehot", "scatter"):
        hp = dict(GBDT_HP, n_rounds=rounds, hist_mode=mode)
        yield Program(f"gbdt_{mode}", lambda hp=hp: train_gbdt(tb, ty, tw, tbase, **hp), None,
                      _src(train_gbdt), width, mode == "onehot",
                      "" if mode == "onehot" else SCATTER_NOTE)
    trees = train_gbdt(tb, ty, tw, tbase, **dict(GBDT_HP, n_rounds=rounds, hist_mode="onehot"))
    yield Program("gbdt_predict_margin", lambda: predict_margin(trees, tb, tbase, depth=5), None,
                  _src(predict_margin), width)


def _mil_program(device, small):
    from pd_fusion_torch.nn.mil import mil_init, train_mil_impl

    n, L, D, H, A, bs = (8, 4, 16, 8, 4, 4) if small else (80, 48, 2048, 256, 128, 16)
    g = torch.Generator(device=device).manual_seed(1)
    X = torch.randn(n, L, D, generator=g, device=device)
    M = torch.ones(n, L, device=device)
    M[1, L // 2:] = 0.0
    y = (torch.arange(n, device=device) % 2).float()
    ones = torch.ones(n, device=device)
    p0 = mil_init(torch.Generator().manual_seed(0), D, H, A, True, device=device)

    def fn(state):
        params, gen = state
        return train_mil_impl(params, X, M, y, ones, X, M, y, ones, gen, 5e-4, 1.0, 1.0, 2, bs,
                              True, 0.2, 1e-3, True, True, patience=8)

    yield Program("mil_trainer_k1", fn,
                  lambda: (_to(p0, device), torch.Generator(device=device).manual_seed(2)),
                  _src(train_mil_impl), f"{n} bags x {L} x {D}, head {H}/{A} gated, batch {bs}, "
                  "2 epochs (K1 forward, its torch-op backward)")


def _imaging_programs(device, small):
    from pd_fusion_torch.imaging import pipeline
    from pd_fusion_torch.models import ft_checks as fc
    from pd_fusion_torch.models import mil_attention_finetune as ft
    from pd_fusion_torch.nn.resnet import load_backbone, params_to

    W, L, hw, size = (1, 2, 32, 32) if small else (pipeline.SUBJECTS_PER_CALL, 48, 160, 224)
    params50, _, _ = load_backbone("resnet50", seed=0)
    folded = pipeline.fold_backbone(params_to(params50, device=device), "resnet50")
    g = torch.Generator().manual_seed(4)
    x = torch.rand(W, L, hw, hw, generator=g).to(device)
    half = torch.full((3,), 0.5, device=device)

    def flush():
        with torch.inference_mode():
            return pipeline._embed(folded, x, half, half, "resnet50", size, True)

    yield Program("resnet50_embed_flush", flush, None, _src(pipeline._embed),
                  f"{W} subjects x {L} slices {hw}^2 -> {size}^2, float32")

    B, L = (2, 2) if small else (4, 64)
    backbone, head = fc.start_params()
    batch = fc.step_inputs(B, L, hw, seed=3, ragged=False)
    hyper = dict(fc.hyper(device), input_size=size)

    def state():
        bp, hp = params_to(backbone, device=device), params_to(head, device=device)
        opt = {"backbone": ft.ft_optim.init_group(ft.trainable_leaves(bp)),
               "head": ft.ft_optim.init_group(ft.trainable_leaves(hp))}
        return bp, hp, opt, {k: torch.as_tensor(v, device=device) for k, v in batch.items()}

    for name, gate in (("ft_step_frozen", 0.0), ("ft_step_unfrozen", 1.0)):
        def fn(s, gate=gate):
            bp, hp, opt, b = s
            bp, hp, loss = ft.ft_step(bp, hp, opt, b, gate, hyper)
            return {"backbone": bp, "head": hp, "loss": loss, "opt": opt}
        yield Program(name, fn, state, _src(ft.ft_step),
                      f"B={B} bags x L={L} slices {hw}^2 -> {size}^2, ResNet-50 train-mode BN, "
                      f"gate {gate:g}", not gate, FT_NOTE if gate else "")


def _volume_programs(device, small):
    from pd_fusion_torch.nn import cnn3d
    from pd_fusion_torch.nn import cnn3d_checks as cc
    from pd_fusion_torch.ops.volume_stats import simple_volume_features

    cfg = ({"target_shape": (16, 16, 16), "embedding_dim": 8, "batch_size": 2, "lr": 1e-3}
           if small else cc.CNN_CONFIG)
    shape, B, E = tuple(cfg["target_shape"]), int(cfg["batch_size"]), int(cfg["embedding_dim"])
    x = torch.from_numpy(cc.synthetic_volumes(B, shape, seed=5)).to(device)[:, None]
    wb = torch.ones(B, device=device)
    p0 = cnn3d.params_to(cnn3d.cnn3d_init(torch.Generator().manual_seed(0), shape, E), device)

    def state():
        p = _to(p0, device)
        return p, cnn3d.init_opt(p)

    def step(s):
        p, opt = s
        new, loss = cnn3d.train_step(p, opt, x, wb, cfg["lr"], shape)
        return {"params": new, "loss": loss, "opt": opt}

    yield Program("cnn3d_train_step", step, state, _src(cnn3d.train_step),
                  f"{shape}, embedding {E}, batch {B}")

    nv, vshape = (2, (16, 16, 16)) if small else (8, (96, 96, 96))
    vols = torch.from_numpy(cc.synthetic_volumes(nv, vshape, seed=7)).to(device)
    yield Program("simple_volume_features", lambda: simple_volume_features(vols, 10, 8, False),
                  None, _src(simple_volume_features), f"{nv} volumes of {vshape}, 10 bins, grid 8")


def _suite_programs(device, small):
    from pd_fusion_torch.analysis import sweep_checks as sc
    from pd_fusion_torch.analysis.tabular import SUITE_GBDT
    from pd_fusion_torch.analysis.tabular_checks import LOGREG_SHAPE, on_device, tabular_data
    from pd_fusion_torch.nn.gbdt import DeviceHistGBDT, bin_features
    from pd_fusion_torch.nn.logreg import BalancedLogisticRegression
    from pd_fusion_torch.ops import treeshap
    from pd_fusion_torch.scripts import ppmi_stress_test as st
    from pd_fusion_torch.scripts.ppmi_train_tabular import train_mlp

    n, d = (60, 5) if small else LOGREG_SHAPE
    X, y = tabular_data(n, d, seed=0, miss=0.0)
    X = (X - X.mean(0)) / X.std(0)

    def logreg():
        with on_device(device):
            m = BalancedLogisticRegression(max_iter=2000).fit(X, y)
        return {"coef": m.coef_, "intercept": m.intercept_, "n_iter": m.n_iter_}

    yield Program("logreg_fit", logreg, None, _src(BalancedLogisticRegression.fit),
                  f"{n} x {d}, float64 Newton")

    n, d = (80, 6) if small else (1500, 348)
    cfg = dict(MLP_CFG, hidden_dims=[8], max_epochs=5) if small else MLP_CFG
    Xm, ym = tabular_data(n, d, seed=1, miss=0.0)
    Xm = ((Xm - Xm.mean(0)) / Xm.std(0)).astype(np.float32)
    cut = n * 7 // 10

    def mlp():
        with on_device(device):
            return train_mlp(Xm[:cut], ym[:cut], Xm[cut:], ym[cut:], 42, cfg)(Xm[cut:])

    yield Program("mlp_earlystop", mlp, None, _src(train_mlp),
                  f"{cut} x {d} -> {cfg['hidden_dims']}, {cfg['max_epochs']} epochs, "
                  f"patience {cfg['patience']}")

    inp = (sc.stress_inputs(n=60, F=10, epochs=2, batch_size=16) if small
           else sc.stress_inputs(epochs=5))

    def stress(a):
        return st.fit_moddrop_mlp(a["params"], a["X"], a["y"], a["clin"], a["img"], a["draws"],
                                  sc.STRESS_HP["lr"], a["batch_size"])

    yield Program("stress_fold", stress, lambda: _to(inp, device), _src(st.fit_moddrop_mlp),
                  f"{tuple(inp['X'].shape)}, batch {inp['batch_size']}, "
                  f"{inp['draws'][0].shape[0]} epochs")

    n, f = (80, 5) if small else (1200, 186)
    Xs, ys = tabular_data(n, f, seed=2)
    Xs = Xs.astype(np.float32)
    with on_device(device):
        model = DeviceHistGBDT(**dict(SUITE_GBDT, n_estimators=5 if small else 300)).fit(Xs, ys)
        trees = model._device_trees()
    rows = min(treeshap._CHUNK, n)
    bins = torch.as_tensor(bin_features(Xs[:rows], model.edges_), device=device).to(torch.int64)
    yield Program("treeshap_chunk", lambda: treeshap._shap_chunk(trees, bins, model.max_depth, f),
                  None, _src(treeshap._shap_chunk),
                  f"{rows} rows, {model.n_estimators} trees depth {model.max_depth}, {f} features")


PROGRAM_GROUPS = (_metric_programs, _tabular_programs, _gbdt_programs, _mil_program,
                  _imaging_programs, _volume_programs, _suite_programs)


def programs(device, size: str = "full") -> Iterator[Program]:
    """Every device program of the port's paths, built one after the other
    (each group's inputs are freed once it is consumed)."""
    if size not in ("full", "small"):
        raise ValueError(f"size is 'full' or 'small', not {size!r}")
    for group in PROGRAM_GROUPS:
        yield from group(torch.device(device), size == "small")


def program(name: str, device="cuda", size: str = "full") -> Program:
    """One program of ``programs`` by name (the groups before its own are
    built on the way)."""
    found = next((p for p in programs(device, size) if p.name == name), None)
    if found is None:
        raise KeyError(f"no program {name!r}")
    return found


def audit(progs: Iterable[Program]) -> List[Dict]:
    """Each program twice (``run_twice``, timed) and once under the
    deterministic mode (``flagged_ops``) -> one record a program."""
    rows = []
    for prog in progs:
        call = (lambda p=prog: p.fn(p.make_state())) if prog.make_state else prog.fn
        t0 = time.perf_counter()
        twice = run_twice(prog.fn, prog.make_state)
        seconds = time.perf_counter() - t0
        flagged = flagged_ops(call)
        rows.append({
            "name": prog.name, "source": prog.source, "width": prog.width,
            "equal": all(eq for eq, _ in twice.values()),
            "gap": max((g for _, g in twice.values()), default=0.0),
            "unequal_outputs": [k for k, (eq, _) in twice.items() if not eq],
            "flagged": flagged, "deterministic": prog.deterministic, "note": prog.note,
            "two_runs_s": seconds})
    return rows


def failures(rows: Iterable[Dict]) -> List[str]:
    """The programs listed as deterministic whose two runs differ."""
    return [f"{r['name']} ({r['source']}): outputs {r['unequal_outputs'][:5]} differ, gap "
            f"{r['gap']:.3e}" for r in rows if r["deterministic"] and not r["equal"]]
