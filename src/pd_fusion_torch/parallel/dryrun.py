"""Multi-device dry run: every sharded path against its one-card run (the
counterpart of ``__graft_entry__.dryrun_multichip``, which stays the JAX
package's).

    torchrun --standalone --nproc-per-node N -m pd_fusion_torch.parallel.dryrun \\
        [--size small|full] [--mesh FxD[,FxD...]] [--out result.json]

(ranks that share a card: ``PD_FUSION_TORCH_DIST_BACKEND=gloo``; ranks on
the CPU: ``PD_FUSION_TORCH_DEVICE=cpu``). The ranks form the JAX dry
run's mesh, ``fold = 2`` when N is even, ``data = N // fold`` (``--mesh``
names others: each of them runs the three CV-engine legs), and run six
legs. In each, rank 0 first runs the leg on one rank (the "world-1" run,
the other ranks waiting), then every rank runs its share on the mesh; the
sharded result, gathered, is held against the one-rank result on rank 0
and the largest difference is broadcast, so every rank fails together:

- ``moddrop``: the CV engine's minibatch ModDrop trainer, 5 epochs, K
  folds over ``fold``, each fold's rows over ``data`` (and ``fullbatch``,
  the other MLP families' trainer, 5 full-batch steps, the same way);
- ``moe``: the MoE fold trainer, 5 full-batch epochs, the same sharding;
- ``gbdt``: the per-level histograms under both lowerings (the sums are
  held; a summation order may flip a near-tie split, so the margins are
  not), and the train ROC-AUC of sharded 8-round ensembles within 2e-2;
- ``mil_ft``: one unfrozen MIL fine-tune step (train-mode BN with the
  whole batch's statistics, the gradient sum, the global-norm clip, K1 in
  every rank's head) with the bags over every rank, params replicated;
  and (``mil_ft_grads``) the step's all-reduced gradients in float64;
- ``cnn3d``: the CNN3D autoencoder's training and embeddings, the volumes
  over every rank;
- ``embed``: one embed flush of the ResNet pipeline, the subjects over
  every rank.

Tolerances are the JAX dry run's: 5e-4 on params and histogram sums, 2e-2
on the GBDT train AUC; 5e-5 on the embeddings (``tests/test_multichip.py``'s
embed band); 1e-9 on the float64 gradients, each leaf relative to its
largest element (rounding alone gives about 1e-13; a wrong collective,
order 1). The data axis's replicas must also be bitwise equal after
training. ``--size full`` runs the MIL-FT leg at the fine-tune config's
width (ResNet-50, 224 px, 4 bags of 64 slices) and CNN3D at the data
config's (64^3, embedding 64, batch 8); ``small`` is the CPU test's size.
Prints ``dryrun_multichip EQUIVALENCE: ...`` and ``dryrun_multichip OK:
mesh=(FxD) ...`` on rank 0.
"""
import argparse
import contextlib
import json
import time

import numpy as np
import torch

from pd_fusion_torch.parallel import distributed

TOL = {"params": 5e-4, "grads": 1e-9, "hist": 5e-4, "gbdt_auc": 2e-2, "embed": 5e-5}

SIZES = {
    "small": {"ft_arch": "resnet18", "ft_px": 32, "ft_slices": 4, "ft_hw": (24, 24),
              "ft_hidden": 32, "ft_attn": 16, "cnn_shape": (16, 16, 16), "cnn_emb": 8,
              "cnn_bs": 4, "cnn_epochs": 2},
    "full": {"ft_arch": "resnet50", "ft_px": 224, "ft_slices": 64, "ft_hw": (160, 160),
             "ft_hidden": 256, "ft_attn": 128, "cnn_shape": (64, 64, 64), "cnn_emb": 64,
             "cnn_bs": 8, "cnn_epochs": 1},
}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _flat(tree):
    """Tensor leaves of a nested dict/list, dict keys sorted."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _flat(v)]
    return [tree]


def _max_diff(a, b) -> float:
    worst = 0.0
    for x, y in zip(_flat(a), _flat(b)):
        if x.shape != y.shape:
            return float("inf")
        d = (x.detach().double().cpu() - y.detach().double().cpu()).abs()
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    return worst


def _max_rel_diff(a, b) -> float:
    """The largest over the leaves of max|a - b| / max|a|, where max|a| is
    at least a thousandth of the largest max|a| of all leaves: a leaf whose
    gradient is zero by symmetry (the attention score's bias, which the
    softmax ignores) holds rounding noise only."""
    scales = [float(x.detach().abs().max()) if x.numel() else 0.0 for x in _flat(a)]
    floor = 1e-3 * max(scales, default=0.0)
    return max((_max_diff(x, y) / max(s, floor, 1e-30)
                for x, y, s in zip(_flat(a), _flat(b), scales)), default=0.0)


@contextlib.contextmanager
def _plain_kernels():
    """The MIL head pools with K1's plain version and every train-mode BN
    takes the fused BN's plain version (for a float64 check; the kernels
    take float32 only)."""
    from pd_fusion_torch.nn import mil
    from pd_fusion_torch.ops.attention_pool import attention_pool_reference
    from pd_fusion_torch.ops.weighted_bn_checks import plain_everywhere

    kernel, mil.attention_pool = mil.attention_pool, attention_pool_reference
    try:
        with plain_everywhere():
            yield
    finally:
        mil.attention_pool = kernel


class _Legs:
    """Times and checks the legs: ``world1`` runs on rank 0 alone,
    ``sharded`` on every rank; ``check`` compares on rank 0 and raises on
    every rank when the broadcast difference is over the tolerance. After
    each leg a rank hands its cached device blocks back: ranks that share
    one card (two over gloo) then find it free for the next leg, whose
    full-width float64 step keeps every activation for its backward."""

    def __init__(self, dev):
        self.dev = dev
        self.diffs, self.walls = {}, {}

    def _done(self):
        _sync(self.dev)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def world1(self, name, fn):
        out = None
        if distributed.is_primary():
            _sync(self.dev)
            t0 = time.perf_counter()
            out = fn()
            self._done()
            self.walls[f"{name}_world1_s"] = time.perf_counter() - t0
        distributed.barrier()
        return out

    def sharded(self, name, fn):
        distributed.barrier()
        _sync(self.dev)
        t0 = time.perf_counter()
        out = fn()
        self._done()
        distributed.barrier()
        self.walls[f"{name}_sharded_s"] = time.perf_counter() - t0
        return out

    def check(self, name, ref, got, tol, diff=_max_diff):
        d = diff(ref, got) if distributed.is_primary() else 0.0
        d = float(distributed.broadcast(torch.tensor([d], dtype=torch.float64), 0)[0])
        self.diffs[name] = max(self.diffs.get(name, 0.0), d)
        if not d <= tol:
            raise AssertionError(f"{name}: sharded != one rank, max|diff|={d:.3e} > {tol}")
        return d


def _replicas_equal(tensors, group) -> bool:
    """Every rank of ``group`` holds bitwise the same tensors."""
    return all(torch.equal(o, t) for t in _flat(tensors)
               for o in distributed.all_gather(t, group))


def _warm_up(dev):
    """A process's first Adam step and first products pay one-time costs
    (lazy imports, the CUDA libraries' handles) that belong to no leg."""
    from pd_fusion_torch.nn.mlp import mlp_init
    from pd_fusion_torch.nn.trainer import fullbatch_impl

    p = mlp_init(torch.Generator().manual_seed(0), [4, 4, 1], device=dev)
    x = torch.zeros((8, 4), device=dev)
    fullbatch_impl(p, x, x[:, 0], None, None, 1e-3, 2, 0.0)
    _sync(dev)


def _cv_legs(legs, replicas, mesh, tag, dev, t):
    """The moddrop, MoE and GBDT legs on one (fold, data) mesh; the walls
    and replica checks keyed with ``tag``."""
    from pd_fusion_torch.nn.gbdt import (
        _histograms,
        bin_features,
        fit_bin_edges,
        predict_margin,
        train_gbdt,
    )
    from pd_fusion_torch.nn.mlp import mlp_init
    from pd_fusion_torch.nn.moe import map_params, train_moe_folds
    from pd_fusion_torch.nn.trainer import fullbatch_impl, minibatch_moddrop_impl
    from pd_fusion_torch.ops.metrics import binary_metrics
    from pd_fusion_torch.parallel.cv_engine import (
        _data_group,
        _init_folds_moe,
        _mesh_slices,
        _shard_cv_inputs,
        _stack_params,
    )

    fold_dim, data_dim = mesh.shape
    dgroup = _data_group(mesh)
    K = max(fold_dim * 2, 2)  # folds divisible by the fold axis
    N = 64 * data_dim  # rows divisible by the data axis
    F, M = 16, 3
    assign = np.zeros((F, M), np.float32)
    assign[:6, 0] = assign[6:10, 1] = assign[10:, 2] = 1.0
    rng = np.random.RandomState(0)
    X = rng.randn(K, N, F).astype(np.float32)
    y = rng.randint(0, 2, (K, N)).astype(np.float32)
    w = np.ones((K, N), np.float32)
    folds, rows = _mesh_slices(mesh, K, N)

    # ---- moddrop: 5 epochs of the flagship minibatch + ModDrop trainer ----
    params = _stack_params([mlp_init(torch.Generator().manual_seed(i), [F, 32, 1], device=dev)
                            for i in range(K)])

    def gens():
        return [torch.Generator(device=dev).manual_seed(100 + i) for i in range(K)]

    def moddrop(p, Xa, ya, wa, g, group=None):
        return minibatch_moddrop_impl(p, Xa, ya, wa, t(assign), g, 1e-3, 5, 32, 0.2, 0.0, 0.3,
                                      data_group=group)

    def fullbatch(p, Xa, ya, wa, g, group=None):
        return fullbatch_impl(p, Xa, ya, wa, g, 1e-3, 5, 0.2, 0.0, data_group=group)

    # the other MLP families' full-batch trainer too (5 steps, dropout 0.2)
    for name, train in (("moddrop", moddrop), ("fullbatch", fullbatch)):
        ref = legs.world1(f"{name}{tag}", lambda: train(params, t(X), t(y), t(w), gens()))

        def sharded():
            p, arrays, g = _shard_cv_inputs(mesh, params, [X, y, w], gens())
            out = train(p, *[t(a) for a in arrays], g, dgroup)
            replicas[f"{name}{tag}"] = _replicas_equal(out, mesh.data_group)
            return [{k: distributed.gather_folds(v, mesh) for k, v in layer.items()}
                    for layer in out]

        legs.check(name, ref, legs.sharded(f"{name}{tag}", sharded), TOL["params"])

    # ---- moe: the stacked-expert trainer, x sharded (fold, None, data) ----
    mdims = {"clinical": 6, "datspect": 4, "mri": 6}
    xs = rng.randn(K, M, N, max(mdims.values())).astype(np.float32)
    mk = np.ones((K, N, M), np.float32)
    moe_params = _init_folds_moe([torch.Generator().manual_seed(i) for i in range(K)], mdims,
                                 [16], [8], dev)
    ref = legs.world1(f"moe{tag}", lambda: train_moe_folds(moe_params, t(xs), t(mk), t(y), t(w), 1e-3,
                                                     5, 0.0))

    def moe_sharded():
        p = map_params(moe_params, lambda v: v[folds])
        out = train_moe_folds(p, t(xs[folds][:, :, rows]), t(mk[folds, rows]), t(y[folds, rows]),
                              t(w[folds, rows]), 1e-3, 5, 0.0, data_group=dgroup)
        replicas[f"moe{tag}"] = _replicas_equal(out, mesh.data_group)
        return map_params(out, lambda v: distributed.gather_folds(v, mesh))

    legs.check("moe", ref, legs.sharded(f"moe{tag}", moe_sharded), TOL["params"])

    # ---- gbdt: histogram sums under both lowerings, then sharded ensembles ----
    Fg = 12
    Xg = rng.randn(K * N, Fg).astype(np.float32)
    Xg[rng.rand(K * N, Fg) < 0.08] = np.nan  # missing-direction learning
    bins = bin_features(Xg, fit_bin_edges(Xg)).reshape(K, N, Fg).astype(np.int64)
    yg = (np.nan_to_num(Xg[:, 0]) + 0.5 * rng.randn(K * N) > 0).astype(np.float32).reshape(K, N)
    gb_data = np.stack([rng.randn(K, N), np.abs(rng.randn(K, N)), np.ones((K, N))],
                       axis=-1).astype(np.float32)
    node = (bins[:, :, 0] % 4).astype(np.int64)
    gb_hp = dict(n_rounds=8, depth=4, lr=0.1, lam=0.0, min_child_weight=1e-3,
                 min_child_samples=5.0)
    base = np.zeros(K, np.float32)

    def train_auc(trees):
        m = predict_margin(trees, t(bins), t(base), depth=gb_hp["depth"])
        return binary_metrics(t(yg), torch.sigmoid(m), t(w))["roc_auc"]

    for mode in ("scatter", "onehot"):
        ref = legs.world1(f"gbdt_{mode}{tag}", lambda: (
            _histograms(t(bins), t(gb_data), t(node), 4, mode)[0],
            train_auc(train_gbdt(t(bins), t(yg), t(w), t(base), hist_mode=mode, **gb_hp))))

        def gbdt_sharded():
            hist = _histograms(t(bins[folds, rows]), t(gb_data[folds, rows]),
                               t(node[folds, rows]), 4, mode, data_group=dgroup)[0]
            trees = train_gbdt(t(bins[folds, rows]), t(yg[folds, rows]), t(w[folds, rows]),
                               t(base[folds]), hist_mode=mode, data_group=dgroup, **gb_hp)
            replicas[f"gbdt_{mode}{tag}"] = _replicas_equal(trees, mesh.data_group)
            trees = {k: distributed.gather_folds(v, mesh) for k, v in trees.items()}
            return distributed.gather_folds(hist, mesh), train_auc(trees)

        got = legs.sharded(f"gbdt_{mode}{tag}", gbdt_sharded)
        legs.check("gbdt", None if ref is None else ref[0], got[0], TOL["hist"])
        legs.check("gbdt_auc", None if ref is None else ref[1], got[1], TOL["gbdt_auc"])




def run(size: str = "small", meshes=None) -> dict:
    """The six legs on this process group (every rank calls it); the
    moddrop, MoE and GBDT legs once on each (fold, data) shape of
    ``meshes`` (by default the JAX dry run's). -> on every rank: {"mesh",
    "diffs", "walls", "replicas_equal", "k1_launches" and "k2_launches"
    (per rank: K1's and the fused BN's kernel launches in the sharded MIL-FT
    step, whose BN keeps its torch ops), "peak_mib" (per rank, CUDA
    only)}."""
    import torch.distributed as dist

    from pd_fusion_torch.imaging.pipeline import embed_slices_batch
    from pd_fusion_torch.models.mil_attention_finetune import (
        ft_grads,
        ft_step,
        trainable_leaves,
    )
    from pd_fusion_torch.nn import cnn3d, ft_optim
    from pd_fusion_torch.nn.mil import mil_init
    from pd_fusion_torch.nn.resnet import (
        IMAGENET_MEAN,
        IMAGENET_STD,
        emb_dim,
        init_resnet,
        params_to,
    )
    from pd_fusion_torch.ops import attention_pool, weighted_bn
    from pd_fusion_torch.utils.device import get_device

    cfg = SIZES[size]
    dev = get_device()
    W, me = distributed.world_size(), distributed.rank()
    world = dist.group.WORLD if W > 1 else None
    if meshes is None:
        fold_dim = 2 if W % 2 == 0 and W > 1 else 1
        meshes = [(fold_dim, W // fold_dim)]
    if any(f * d != W for f, d in meshes):
        raise ValueError(f"every mesh must hold the {W} ranks: {meshes}")
    legs = _Legs(dev)
    replicas = {}
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731
    _warm_up(dev)
    for fold_dim, data_dim in meshes:
        tag = "" if len(meshes) == 1 else f"_{fold_dim}x{data_dim}"
        _cv_legs(legs, replicas, distributed.fold_data_mesh(fold_dim, data_dim, dev.type), tag,
                 dev, t)

    # ---- mil_ft: one unfrozen fine-tune step, bags over every rank ----
    arch, L, (hf, wf) = cfg["ft_arch"], cfg["ft_slices"], cfg["ft_hw"]
    B = W * -(-4 // W)  # 4 bags, or one per rank
    backbone = params_to(init_resnet(torch.Generator().manual_seed(5), arch), device=dev)
    head = mil_init(torch.Generator().manual_seed(6), emb_dim(arch), cfg["ft_hidden"],
                    cfg["ft_attn"], False, device=dev)
    hyper = {"arch": arch, "gated": False, "input_size": cfg["ft_px"],
             "mean": t(np.float32([0.5] * 3)), "std": t(np.float32([0.5] * 3)),
             "loss_type": "bce", "pos_weight": 1.0, "focal_gamma": 2.0, "focal_alpha": 0.25,
             "head_dropout": 0.0, "lr_backbone": 1e-4, "lr": 3e-4, "weight_decay": 1e-3,
             "max_grad_norm": 1.0}
    ft_rng = np.random.RandomState(7)
    batch_np = {"slices": ft_rng.rand(B, L, hf, wf).astype(np.float32),
                "bag_mask": np.ones((B, L), np.float32), "bn_mask": np.ones((B, L), np.float32),
                "y": ft_rng.randint(0, 2, B).astype(np.float32),
                "valid": np.ones(B, np.float32), "angle": np.zeros(B, np.float32),
                "translate": np.zeros((B, 2), np.float32), "scale": np.ones(B, np.float32),
                "shift": np.zeros(B, np.float32),
                "noise": np.zeros((B, L, hf, wf), np.float32)}

    def opt_state():
        return {"backbone": ft_optim.init_group(trainable_leaves(backbone)),
                "head": ft_optim.init_group(trainable_leaves(head))}

    def grads64(batch, group=None):
        """The step's gradients in float64 (the plain pool and BN: the
        kernels take float32)."""
        b64, h64 = params_to(backbone, dtype=torch.float64), params_to(head, dtype=torch.float64)
        hyper64 = dict(hyper, mean=hyper["mean"].double(), std=hyper["std"].double())
        with _plain_kernels():
            return ft_grads(b64, h64, {k: v.double() for k, v in batch.items()}, 1.0, hyper64,
                            group=group)[:2]

    whole = {k: t(v) for k, v in batch_np.items()}
    bags = distributed.local_slice(B, W, me)
    local_batch = {k: t(v[bags]) for k, v in batch_np.items()}
    # Adam's first step moves each weight by at most its lr whatever its
    # gradient, so the params alone would pass a wrong gradient; and float32
    # gradients through train-mode BN at a random init are ill-conditioned,
    # the one-rank step's as far from float64 as the sharded step's. So the
    # all-reduced float64 gradients are held to the one-rank float64
    # gradients, each leaf against its scale.
    ref = legs.world1("mil_ft_grads", lambda: grads64(whole))
    got = legs.sharded("mil_ft_grads", lambda: grads64(local_batch, world))
    legs.check("mil_ft_grads", ref, got, TOL["grads"], _max_rel_diff)
    ref = legs.world1("mil_ft", lambda: ft_step(backbone, head, opt_state(), whole, 1.0,
                                                hyper)[:2])
    attention_pool.reset_launch_counts()
    weighted_bn.reset_launch_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    got = legs.sharded("mil_ft", lambda: ft_step(backbone, head, opt_state(), local_batch, 1.0,
                                                 hyper, group=world)[:2])
    k1, k2 = attention_pool.launch_counts["kernel"], weighted_bn.launch_counts["kernel"]
    peak = torch.cuda.max_memory_allocated(dev) / 2**20 if dev.type == "cuda" else 0.0
    replicas["mil_ft"] = _replicas_equal(got, world)
    legs.check("mil_ft", ref, got, TOL["params"])

    # ---- cnn3d: autoencoder training + embeddings, volumes over every rank ----
    shape = cfg["cnn_shape"]
    n_vol = max(2 * W, 2 * cfg["cnn_bs"])
    vols = np.random.RandomState(8).randn(n_vol, 1, *shape).astype(np.float32)
    cparams = cnn3d.cnn3d_init(torch.Generator().manual_seed(3), shape, cfg["cnn_emb"],
                               device=dev)

    def cnn(v, group=None):
        g = torch.Generator(device=dev).manual_seed(4)
        p = cnn3d.train_cnn3d(cparams, t(v), 1e-3, shape, cfg["cnn_epochs"], cfg["cnn_bs"],
                              generator=g, group=group)
        return p, cnn3d.cnn3d_embed(p, t(v), shape, group=group)

    ref = legs.world1("cnn3d", lambda: cnn(vols))
    got = legs.sharded("cnn3d", lambda: cnn(vols[distributed.local_slice(n_vol, W, me)], world))
    replicas["cnn3d"] = _replicas_equal(got[0], world)
    legs.check("cnn3d", ref, got, TOL["params"])

    # ---- embed: one flush of the embed pipeline, subjects over every rank ----
    We = 2 * W
    eslices = np.random.RandomState(9).rand(We, 2, 40, 40).astype(np.float32)
    eparams = params_to(init_resnet(torch.Generator().manual_seed(5), "resnet18"), device=dev)

    def embed(s):
        return embed_slices_batch(eparams, t(s), t(IMAGENET_MEAN), t(IMAGENET_STD), "resnet18",
                                  64, False)

    ref = legs.world1("embed", lambda: embed(eslices))
    got = legs.sharded("embed", lambda: distributed.gather_rows(
        embed(eslices[distributed.local_slice(We, W, me)]), world))
    legs.check("embed", ref, got, TOL["embed"])

    if not all(replicas.values()):
        raise AssertionError(f"replicas differ: {replicas}")
    per_rank = distributed.all_gather(torch.tensor([float(k1), peak, float(k2)],
                                                   dtype=torch.float64), world)
    result = {
        "meshes": [list(m) for m in meshes], "world_size": W, "size": size,
        "ft_bags": B, "ft_slices": L, "ft_px": cfg["ft_px"],
        "ft_arch": arch, "diffs": legs.diffs, "walls": legs.walls,
        "replicas_equal": replicas, "backend": distributed.backend(),
        "k1_launches": [int(r[0]) for r in per_rank],
        "k2_launches": [int(r[2]) for r in per_rank],
        "peak_mib": [float(r[1]) for r in per_rank],
    }
    if distributed.is_primary():
        d = legs.diffs
        print(f"dryrun_multichip EQUIVALENCE: moddrop={d['moddrop']:.2e} "
              f"fullbatch={d['fullbatch']:.2e} moe={d['moe']:.2e} "
              f"gbdt={d['gbdt']:.2e} gbdt_auc={d['gbdt_auc']:.2e} mil_ft_{cfg['ft_px']}="
              f"{d['mil_ft']:.2e} mil_ft_grads={d['mil_ft_grads']:.2e} cnn3d={d['cnn3d']:.2e} embed={d['embed']:.2e}", flush=True)
        shapes = "+".join(f"({f}x{d})" for f, d in meshes)
        print(f"dryrun_multichip OK: mesh={shapes} ft_bags={B}x{L}slices@{cfg['ft_px']}px "
              f"ranks={W} backend={distributed.backend()}", flush=True)
    return result


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="multi-device dry run of pd_fusion_torch")
    parser.add_argument("--size", choices=sorted(SIZES), default="small")
    parser.add_argument("--mesh", type=str, default=None,
                        help="(fold, data) shapes for the CV-engine legs, e.g. 2x1,1x2")
    parser.add_argument("--out", type=str, default=None, help="result JSON (rank 0 writes it)")
    args = parser.parse_args(argv)
    meshes = None if args.mesh is None else [
        tuple(int(v) for v in m.split("x")) for m in args.mesh.split(",")]
    with distributed.process_group(kernels=True):
        result = run(args.size, meshes)
        if args.out and distributed.is_primary():
            with open(args.out, "w") as f:
                json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
