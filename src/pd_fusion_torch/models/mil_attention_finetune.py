"""End-to-end MIL fine-tune: a 2D backbone over slice bags and the
attention-pooling head, trained together (port of
``pd_fusion/models/mil_attention_finetune.py``). The backbone is
``backbone: resnet18`` or ``resnet50`` (``nn/resnet.py``, the JAX
package's two), ``swin_t`` (``nn/swin.py``) or ``maxvit_t``
(``nn/maxvit.py``), the port's own (``_family``: each name's loader,
train-mode forward and inference forward).

Bags are NIfTI paths (or prepped slice arrays). Per bag: the native host
prep (read, resize, 1-99% percentile normalize, multi-axis slice gather:
``imaging/native.py::prep_slices_native``, which raises on failure) ->
train-time augmentation -> 224^2 3-channel ImageNet batch -> backbone ->
zero-padded bags -> MIL attention head (kernel K1 on the card) -> focal or
pos-weighted BCE. The backbone is frozen for the first
``freeze_backbone_epochs`` (a 0/1 gate on its gradient and decay), the
optimizer is ``nn/ft_optim.py`` (global-norm clip, decay off the BN
buffers, Adam at ``lr_backbone`` and ``lr``), batches may be
class-balanced, validation AUC drives early stopping with best-state
restore, and inference averages ``tta_inference`` augmented draws.

A ResNet's BN runs in train mode in every step, frozen or not: batch
statistics over the ``B * L`` images of the batch minus the rows that pad
a ragged final batch (``bn_mask`` = ``valid``; a ``None`` bag inside a
batch counts as valid, and its zero slices enter the statistics, as in
the JAX package), and the running statistics move by their EMA every step; a
MaxViT's BNs do the same. The step
(``ft_step``) computes what the JAX package's ``_ft_update`` computes.
While the gate is 0 the backbone runs outside autograd, so the backward
pass stops at the head: the numbers are the same, and the backbone's Adam
count still advances. A Swin backbone has LayerNorms and no running
statistics: ``bn_mask`` weights nothing there (a row's embedding depends on
that row alone) and a step merges no statistics.

Dispatch: each batch is stepped as soon as it is formed, which is what the
JAX package does under ``PD_FUSION_FT_NO_SCAN=1`` (its ``lax.scan`` flush
is the same math), so ``PD_FUSION_FT_NO_SCAN`` / ``PD_FUSION_FT_SCAN_MB``
do not apply. The host's enqueue of a step (span ``step:ft_step``) is not
small: on an H100 at B=4, L=64 it takes 0.62 s against 0.61 s of device
work for ResNet-50, and 0.12 s against 0.20 s for ResNet-18.

Preparation one item ahead: a step's (a TTA pass's) host work before its
copies, the slice loads, the padded batch and the augmentation draws, is
made on one worker thread while the caller's thread copies and dispatches
the item before (``_prepared_ahead``: span ``trainer:prep_wait``, the
caller's wait for an item; counter ``trainer:prep_ready``, the items that
were ready). The worker alone draws from the call's generator, in the
order below, and only for items that are taken; a pipeline lasts one
epoch of ``train`` (the epoch's checkpoint, validation and early stop run
with no worker) or one ``predict_proba`` call. The copies stay on the
caller's thread, in their order, and each item is made of fresh arrays.

Random draws, in the JAX package's order from a numpy ``Generator`` (an
unseeded ``np.random.default_rng()`` per ``train`` and per
``predict_proba`` call, as there; ``make_rng`` replaces it): per epoch the
permutation or the balanced ``rng.choice`` pairs, then per batch the
angle, translation, intensity scale and shift and the noise over the
padded ``[bs, L_i, h, w]``. The noise is numpy's ``rng.normal(0,
noise_std, shape)`` as float32, bit for bit, drawn on the model's device
by ``ops/normal_draw.py`` (kernel K3 on the card, 0.3 ms with its
read-back where numpy took 0.15-0.19 s a step or pass at B=4, L=64, 160^2;
numpy's own draw on the CPU), which then moves the generator past what it
consumed: so every later draw is numpy's too. On the card the noise is a device tensor that
the caller takes as it is (``normal_draw.hand_over``), with no copy; with
``noise_std`` 0 or augmentation off it is zeros made on the device, and
nothing is drawn. The head's dropout keeps come from a torch generator
split off the seed chain, or from ``train(dropout_keep_fn=)``.

Data parallelism (``ft_step(group=)``, the JAX dry run's MIL-FT leg: bags
sharded over every device, params replicated): each rank steps its own
bags of the batch; every BN takes the whole batch's statistics
(``nn/resnet.py``), the loss is the global mean (its denominator summed
over the group), the gradients are summed over the group, and the
global-norm clip then sees the global gradient. K1 pools every rank's
bags. Head dropout under a group takes its keeps explicitly (the rank's
rows of the whole batch's draw).

Artifacts keep the JAX package's layout, ``{"kind": "mil_attention_ft",
"params", "backbone": <HWIO numpy tree>, "attn": <head numpy tree>}``, so
each package loads the other's file.
"""
import os
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from contextlib import closing
from typing import Callable, Dict, Iterator, NamedTuple, Optional

import numpy as np
import torch

from pd_fusion_torch.imaging import native
from pd_fusion_torch.models.base import BaseModel
from pd_fusion_torch.nn import ft_optim, maxvit, swin
from pd_fusion_torch.nn import mil as mil_nn
from pd_fusion_torch.nn.maxvit import maxvit_apply, maxvit_apply_train
from pd_fusion_torch.nn.mil import mil_apply, mil_init
from pd_fusion_torch.nn.resnet import (
    BN_STATS,
    IMAGENET_MEAN,
    IMAGENET_STD,
    merge_bn_stats,
    params_from_jax,
    params_to,
    params_to_jax,
    resnet_apply,
    resnet_apply_train,
)
from pd_fusion_torch.nn.resnet import load_backbone as load_resnet
from pd_fusion_torch.nn.swin import swin_apply, swin_apply_train
from pd_fusion_torch.ops import normal_draw
from pd_fusion_torch.ops.image import affine2d_subjects, slices_to_imagenet_batch
from pd_fusion_torch.ops.metrics import roc_auc
from pd_fusion_torch.parallel.distributed import all_reduce, all_reduce_grads
from pd_fusion_torch.utils import profiling
from pd_fusion_torch.utils.device import get_device
from pd_fusion_torch.utils.io import load_pickle, save_pickle
from pd_fusion_torch.utils.seed import fresh_generator

KIND = "mil_attention_ft"


class _SliceCache:
    """Byte-budgeted LRU of prepped slice bags, shared across model
    instances and so across CV folds (a CV run makes a model per fold).
    The prepped slices are a pure function of (path, target_shape, axes,
    counts), which is the key. The backbone's embeddings are not cached:
    BN runs in train mode and every train-time load is augmented, so they
    depend on the batch. Budget: ``PD_FUSION_SLICE_CACHE_MB`` (default
    8192; 0 turns the sharing off, the per-instance cache stays)."""

    def __init__(self):
        self._d: OrderedDict = OrderedDict()
        self._bytes = 0

    def _budget(self) -> int:
        return int(float(os.environ.get("PD_FUSION_SLICE_CACHE_MB", "8192")) * 2**20)

    def get(self, key):
        v = self._d.get(key)
        if v is not None:
            self._d.move_to_end(key)
        return v

    def put(self, key, arr) -> None:
        budget = self._budget()
        if budget <= 0 or arr.nbytes > budget:
            return
        old = self._d.pop(key, None)
        if old is not None:
            self._bytes -= old.nbytes
        self._d[key] = arr
        self._bytes += arr.nbytes
        while self._bytes > budget and self._d:
            _, ev = self._d.popitem(last=False)
            self._bytes -= ev.nbytes

    def clear(self) -> None:
        self._d.clear()
        self._bytes = 0


SLICE_CACHE = _SliceCache()


def _flatten(tree, key=None):
    """(key, leaf) pairs in a fixed order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], k)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _flatten(v, key)
    else:
        yield key, tree


def trainable_leaves(tree):
    """Every leaf but the BN running statistics, in ``_flatten`` order."""
    return [t for k, t in _flatten(tree) if k not in BN_STATS]


def replace_trainable(tree, leaves):
    """``tree`` with its trainable leaves replaced, in ``_flatten`` order."""
    it = iter(leaves)

    def go(t, key=None):
        if isinstance(t, dict):
            return {k: go(t[k], k) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [go(v, key) for v in t]
        return t if key in BN_STATS else next(it)

    return go(tree)


def _map_tensors(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tensors(v, fn) for v in tree]
    return fn(tree)


def _clone(tree):
    return _map_tensors(tree, lambda t: t.detach().clone())


def augment(slices, angle, translate, scale, shift, noise):
    """[B, L, h, w] slices -> affine (per bag), intensity scale and shift,
    additive noise, clamped to [0, 1]."""
    aug = affine2d_subjects(slices, angle, translate)
    return torch.clamp(aug * scale[:, None, None, None] + shift[:, None, None, None] + noise,
                       0.0, 1.0)


def ft_loss(logits, y, valid, loss_type, pos_weight, focal_gamma, focal_alpha, denom=None):
    """``sum(loss * valid) / max(sum(valid), 1)`` of focal loss or
    pos-weighted BCE on logits, as the JAX step's ``loss_fn``; ``denom``
    replaces ``sum(valid)`` (the whole batch's, for one rank's bags)."""
    bce = torch.logaddexp(logits, torch.zeros_like(logits)) - y * logits
    denom = torch.sum(valid) if denom is None else denom
    denom = torch.where(denom > 0, denom, 1.0)
    pos = y >= 0.5
    if loss_type == "focal":
        p = torch.sigmoid(logits)
        pt = torch.where(pos, p, 1.0 - p)
        focal = (1.0 - pt) ** focal_gamma
        alpha = torch.where(pos, focal_alpha, 1.0 - focal_alpha)
        return torch.sum(alpha * focal * bce * valid) / denom
    return torch.sum(bce * torch.where(pos, pos_weight, 1.0) * valid) / denom


class _Family(NamedTuple):
    """A backbone family: ``load(arch, weights_path, seed, image_size) ->
    (params, emb_dim, pretrained)``; ``train(params, x, arch,
    sample_weight, group) -> (embeddings, params with the new running
    statistics, or None for a backbone without them)``; ``apply(params, x,
    arch) -> embeddings`` (inference). Each calls this module's names at
    call time, so a wrapper put on them (the benchmark's spans) is taken."""
    load: Callable
    train: Callable
    apply: Callable


_RESNET = _Family(
    lambda arch, path, seed, size: load_resnet(arch, weights_path=path, seed=seed),
    lambda p, x, arch, w, group: resnet_apply_train(p, x, arch, sample_weight=w, group=group),
    lambda p, x, arch: resnet_apply(p, x, arch))
_SWIN = _Family(
    lambda arch, path, seed, size: swin.load_backbone(arch, path, seed, size),
    lambda p, x, arch, w, group: (swin_apply_train(p, x, arch), None),
    lambda p, x, arch: swin_apply(p, x, arch))
_MAXVIT = _Family(
    lambda arch, path, seed, size: maxvit.load_backbone(arch, path, seed),
    lambda p, x, arch, w, group: maxvit_apply_train(p, x, arch, sample_weight=w, group=group),
    lambda p, x, arch: maxvit_apply(p, x, arch))


def _family(arch) -> _Family:
    if swin.is_swin(arch):
        return _SWIN
    if maxvit.is_maxvit(arch):
        return _MAXVIT
    return _RESNET


def load_backbone(arch: str, weights_path=None, seed: int = 0, image_size: int = 224):
    """``arch``'s parameters (CPU tensors) from a checkpoint or the seeded
    init -> (params, emb_dim, pretrained)."""
    return _family(arch).load(arch, weights_path, seed, image_size)


def ft_forward(backbone, head, batch: Dict, hyper: Dict, generator=None,
               train_backbone: bool = True, group=None):
    """The train-mode forward of one batch -> (loss, backbone params with
    the new running statistics, or None for a backbone without them).
    ``batch``: device tensors ``slices`` [B, L, h, w], ``bag_mask``,
    ``bn_mask`` [B, L], ``y``, ``valid`` [B],
    ``angle`` [B], ``translate`` [B, 2], ``scale``, ``shift`` [B],
    ``noise`` [B, L, h, w], and ``keep`` (bool [B, L, H] dropout keeps, or
    None to draw them from ``generator``). ``train_backbone=False`` runs
    the backbone outside autograd. ``group``: the batch is this rank's
    bags of a batch sharded over the group."""
    if group is not None and hyper["head_dropout"] > 0 and batch.get("keep") is None:
        raise ValueError("a data-parallel step takes its head dropout keeps explicitly")
    slices = batch["slices"]
    B, L = slices.shape[:2]
    with torch.set_grad_enabled(train_backbone and torch.is_grad_enabled()):
        aug = augment(slices, batch["angle"], batch["translate"], batch["scale"], batch["shift"],
                      batch["noise"])
        x = slices_to_imagenet_batch(aug.reshape(B * L, *aug.shape[2:]), hyper["input_size"],
                                     hyper["mean"], hyper["std"])
        emb, stats = _family(hyper["arch"]).train(backbone, x, hyper["arch"],
                                                  batch["bn_mask"].reshape(B * L), group)
    logits = mil_apply(head, emb.reshape(B, L, -1), batch["bag_mask"], gated=hyper["gated"],
                       dropout_rate=hyper["head_dropout"], generator=generator,
                       dropout_keep=batch.get("keep"))
    denom = None if group is None else all_reduce(torch.sum(batch["valid"]), group)
    loss = ft_loss(logits, batch["y"], batch["valid"], hyper["loss_type"], hyper["pos_weight"],
                   hyper["focal_gamma"], hyper["focal_alpha"], denom)
    return loss, stats


def ft_grads(backbone, head, batch: Dict, gate: float, hyper: Dict, generator=None,
             group=None):
    """The gradients of ``ft_step``'s loss -> (backbone gradients, ``None``
    while ``gate`` is 0; head gradients; the loss, detached; the new
    running statistics, or None). With ``group`` the gradients are summed
    over the group."""
    on = float(gate) != 0.0
    bp = replace_trainable(backbone, [t.detach().requires_grad_(on)
                                      for t in trainable_leaves(backbone)])
    hp = replace_trainable(head, [t.detach().requires_grad_(True) for t in trainable_leaves(head)])
    b_leaves, h_leaves = trainable_leaves(bp), trainable_leaves(hp)
    loss, stats = ft_forward(bp, hp, batch, hyper, generator, train_backbone=on, group=group)
    grads = torch.autograd.grad(loss, h_leaves + (b_leaves if on else []))
    if group is not None:
        grads = all_reduce_grads(grads, group)
    g_h, g_b = list(grads[:len(h_leaves)]), (list(grads[len(h_leaves):]) if on else None)
    return g_b, g_h, loss.detach(), stats


def ft_step(backbone, head, opt_state, batch: Dict, gate: float, hyper: Dict, generator=None,
            group=None):
    """One augment -> backbone -> head -> loss -> two-group Adam step (the
    JAX package's ``_ft_update``). Functional in the parameters: -> (new
    backbone with the new running statistics if it has any, new head, loss);
    ``opt_state`` (``{"backbone", "head"}`` groups of ``nn/ft_optim.py``)
    is updated in place. While ``gate`` is 0 the backbone stays out of
    autograd and its gradient is the zero gradient. With ``group`` the
    batch is this rank's bags: the gradients are summed over the group
    before the update (so the clip sees the global norm), and the loss
    returned is this rank's share of the global mean. Span ``step:ft_step``:
    the host's enqueue of the step."""
    with profiling.span("step:ft_step"):
        g_b, g_h, loss, stats = ft_grads(backbone, head, batch, gate, hyper, generator, group)
        with torch.no_grad():
            new_b, new_h = ft_optim.ft_update(
                [t.detach() for t in trainable_leaves(backbone)],
                [t.detach() for t in trainable_leaves(head)], g_b, g_h, opt_state,
                gate, hyper["lr_backbone"], hyper["lr"], hyper["weight_decay"],
                hyper["max_grad_norm"])
        backbone = replace_trainable(backbone, new_b)
        if stats is not None:
            backbone = merge_bn_stats(backbone, stats)
        return backbone, replace_trainable(head, new_h), loss


def _prepared_ahead(items: Iterator):
    """The items of generator ``items``, whose first yield is their number,
    each made on a worker thread while the caller uses the one before: the
    worker makes item ``k + 1`` once the caller has taken item ``k``, and
    never one past the last. Use under ``contextlib.closing``: on the last
    item, a raise on either side or an early close, the worker is joined
    before control returns to the caller. The worker's exception is raised
    here with its own type."""
    pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ft-prep")
    try:
        n = pool.submit(next, items).result()
        pending = pool.submit(next, items) if n else None
        for k in range(n):
            ready = pending.done()
            with profiling.span("trainer:prep_wait", trace=False):
                item = pending.result()
            if ready:
                profiling.count("trainer:prep_ready")
            if k + 1 < n:
                pending = pool.submit(next, items)
            yield item
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        items.close()


def val_auc(y, probs) -> float:
    """Validation ROC-AUC (float64, tie-exact); -1.0 where scikit-learn's
    ``roc_auc_score`` would raise: one class only, or a non-finite prob."""
    y = np.asarray(y, np.float64)
    probs = np.asarray(probs, np.float64)
    if len(np.unique(y)) < 2 or not np.isfinite(probs).all():
        return -1.0
    return float(roc_auc(torch.from_numpy(y), torch.from_numpy(probs)))


class MilAttentionFineTuneModel(BaseModel):
    def __init__(self, params: dict, device=None,
                 make_rng: Optional[Callable[[], np.random.Generator]] = None):
        self.params = params or {}
        p = self.params
        self.device = get_device(device)
        self.make_rng = make_rng
        self.backbone_name = p.get("backbone", "resnet50")
        self.target_shape = tuple(p.get("target_shape", (160, 160, 160)))
        if p.get("slice_axes") and p.get("slice_counts"):
            self.axes = [int(a) for a in p["slice_axes"]]
            self.counts = [int(c) for c in p["slice_counts"]]
        else:
            self.axes = [int(p.get("slice_axis", 2))]
            self.counts = [int(p.get("slice_count", 48))]
        self.n_slices = sum(self.counts)
        self.input_size = int(p.get("input_size", 224))
        self.bag_batch_size = int(p.get("batch_size", 4))
        self.tta_inference = int(p.get("tta_inference", 1))
        self.max_rotation = float(p.get("max_rotation_deg", 5.0))
        self.max_translation = float(p.get("max_translation", 0.05))
        self.intensity_scale = float(p.get("intensity_scale", 0.1))
        self.intensity_shift = float(p.get("intensity_shift", 0.1))
        self.noise_std = float(p.get("noise_std", 0.01))
        self.missing_prob = float(p.get("missing_prob", 0.5))
        self.freeze_backbone_epochs = int(p.get("freeze_backbone_epochs", 2))
        self.train_aug = bool(p.get("train_aug", True))
        self.balanced_batches = bool(p.get("balanced_batches", False))
        self.loss_type = str(p.get("loss_type", "bce")).lower()
        self.focal_gamma = float(p.get("focal_gamma", 2.0))
        self.focal_alpha = p.get("focal_alpha")
        self.gated = bool(p.get("gated", False))

        weights_path = p.get("weights_path") if bool(p.get("pretrained", True)) else None
        backbone, self.emb_dim, self.pretrained = load_backbone(
            self.backbone_name, weights_path, int(p.get("seed", 0)), self.input_size)
        self.backbone_params = params_to(backbone, device=self.device)
        if self.pretrained:
            self.mean, self.std = IMAGENET_MEAN, IMAGENET_STD
        else:
            self.mean = np.array([0.5, 0.5, 0.5], np.float32)
            self.std = np.array([0.5, 0.5, 0.5], np.float32)
        self.head_params = mil_init(fresh_generator(), self.emb_dim, int(p.get("hidden_dim", 256)),
                                    int(p.get("attn_dim", 128)), self.gated, device=self.device)
        self.opt_state = None
        self._slice_cache = {}

    def __getstate__(self):
        # a whole-object pickle (CalibratedModel.save) leaves the slice
        # cache and the generator factory behind
        return {k: v for k, v in self.__dict__.items() if k not in ("_slice_cache", "make_rng")}

    def __setstate__(self, state):
        self.__dict__.update(state, _slice_cache={}, make_rng=None)

    def _rng(self) -> np.random.Generator:
        return self.make_rng() if self.make_rng is not None else np.random.default_rng()

    def _t(self, a, dtype=np.float32):
        """``a`` as ``dtype`` on the device: every host-to-device copy of
        ``train`` and ``predict_proba``, counted in ``trainer:h2d_bytes``."""
        with profiling.span("trainer:_t"):
            a = np.asarray(a, dtype)
            profiling.count("trainer:h2d_bytes", a.nbytes)
            return torch.as_tensor(a, device=self.device)

    def _on_device(self, a):
        """An item's array on the device: a host array copied (``_t``), a
        device tensor (the noise, made on the device) taken as it is."""
        return normal_draw.hand_over(a) if isinstance(a, torch.Tensor) else self._t(a)

    @staticmethod
    def _readback(t) -> np.ndarray:
        with profiling.span("trainer:readback", trace=False):  # waits for the device
            return t.cpu().numpy()

    # ---- bag -> normalized slices [n_slices, h, w] -----------------------
    def _load_bag_slices(self, bag) -> Optional[np.ndarray]:
        if bag is None:
            return None
        if isinstance(bag, np.ndarray):
            return bag.astype(np.float32, copy=False)
        key = (str(bag), self.target_shape, tuple(self.axes), tuple(self.counts))
        cached = self._slice_cache.get(key)
        if cached is None:
            cached = SLICE_CACHE.get(key)  # cross-fold: earlier folds' preps
        if cached is not None:
            return cached
        slices = native.prep_slices_native(bag, self.target_shape, self.axes, self.counts)
        self._slice_cache[key] = slices  # instance-local: survives a 0 budget
        SLICE_CACHE.put(key, slices)
        return slices

    def _pad_batch(self, slice_list):
        """list of [L_i, h, w] or None -> padded [B, L, h, w] + mask."""
        real = [s for s in slice_list if s is not None]
        L = max(s.shape[0] for s in real)
        h, w = real[0].shape[1:]
        X = np.zeros((len(slice_list), L, h, w), np.float32)
        mask = np.zeros((len(slice_list), L), np.float32)
        for i, s in enumerate(slice_list):
            if s is not None:
                X[i, : s.shape[0]] = s
                mask[i, : s.shape[0]] = 1.0
        return X, mask

    def _aug_params(self, B, L, h, w, rng, enabled: bool):
        """(angle [B], translate [B, 2] in pixels, scale [B], shift [B], noise
        [B, L, h, w]) as float32, drawn in the JAX package's order; the noise
        made on the device (on the CPU, numpy's own draw)."""
        with profiling.span("trainer:_aug_params"):
            if enabled:
                angle = rng.uniform(-self.max_rotation, self.max_rotation, size=B)
                translate = rng.uniform(-self.max_translation, self.max_translation, size=(B, 2))
                translate = translate * np.array([h, w])
                scale = 1.0 + rng.uniform(-self.intensity_scale, self.intensity_scale, size=B)
                shift = rng.uniform(-self.intensity_shift, self.intensity_shift, size=B)
            else:
                angle, translate = np.zeros(B), np.zeros((B, 2))
                scale, shift = np.ones(B), np.zeros(B)
            if enabled and self.noise_std > 0:
                noise = normal_draw.normal(rng, self.noise_std, (B, L, h, w), self.device)
            else:
                noise = torch.zeros((B, L, h, w), device=self.device)
            return (np.float32(angle), np.float32(translate), np.float32(scale), np.float32(shift),
                    noise)

    def _resolve_pos_weight(self, y):
        if self.params.get("class_weight") == "balanced":
            pos = float((y == 1).sum())
            neg = float((y == 0).sum())
            return neg / pos if pos > 0 else 1.0
        if self.params.get("pos_weight") is not None:
            return float(self.params["pos_weight"])
        return 1.0

    def _epoch_batches(self, y, rng):
        n, bs = len(y), self.bag_batch_size
        if self.balanced_batches:
            pos_idx = np.where(y >= 0.5)[0]
            neg_idx = np.where(y < 0.5)[0]
            if len(pos_idx) and len(neg_idx):
                half = max(1, bs // 2)
                n_batches = max(1, int(np.ceil(n / bs)))
                return [np.concatenate([
                    rng.choice(pos_idx, half, replace=len(pos_idx) < half),
                    rng.choice(neg_idx, bs - half, replace=len(neg_idx) < (bs - half)),
                ]) for _ in range(n_batches)]
        perm = rng.permutation(n)
        return [perm[i: i + bs] for i in range(0, n, bs)]

    def _epoch_steps(self, bags, y, rng):
        """One epoch's steps as host arrays, in the order ``train`` copies
        them: the epoch's batch choices, then per batch its padded slices,
        masks and labels and its augmentation draws. Yields the number of
        steps first (``_prepared_ahead``)."""
        bs = self.bag_batch_size
        # a batch of None bags alone is not stepped, and draws nothing
        taken = [b for b in self._epoch_batches(y, rng) if any(bags[i] is not None for i in b)]
        yield len(taken)
        for bidx in taken:
            # every batch runs at [bs, L_i]: a ragged final batch gets zero
            # rows with valid 0, which keep the loss mean and the BN
            # statistics those of the unpadded batch
            Xb, maskb = self._pad_batch([self._load_bag_slices(bags[i]) for i in bidx])
            B, L_i, h, w = Xb.shape
            X = np.zeros((bs, L_i, h, w), np.float32)
            X[:B] = Xb
            mask = np.zeros((bs, L_i), np.float32)
            mask[:B] = maskb
            valid = np.zeros(bs, np.float32)
            valid[:B] = 1.0  # None bags count toward the mean and the statistics too
            yb = np.zeros(bs, np.float32)
            yb[:B] = y[bidx]
            angle, trans, scale, shift, noise = self._aug_params(bs, L_i, h, w, rng,
                                                                 self.train_aug)
            yield {"slices": X, "bag_mask": mask, "y": yb, "valid": valid,
                   "bn_mask": np.repeat(valid[:, None], L_i, 1), "angle": angle,
                   "translate": trans, "scale": scale, "shift": shift, "noise": noise}

    def _hyper(self, pos_weight):
        max_grad_norm = self.params.get("max_grad_norm")
        focal_alpha = self.focal_alpha if self.focal_alpha is not None else 0.5
        return {
            "arch": self.backbone_name, "gated": self.gated, "input_size": self.input_size,
            "mean": self._t(self.mean), "std": self._t(self.std),
            "loss_type": self.loss_type, "pos_weight": float(np.float32(pos_weight)),
            "focal_gamma": float(np.float32(self.focal_gamma)),
            "focal_alpha": float(np.float32(focal_alpha)),
            "head_dropout": float(self.params.get("dropout", 0.2)),
            "lr_backbone": float(self.params.get("lr_backbone", 1e-4)),
            "lr": float(self.params.get("lr", 3e-4)),
            "weight_decay": float(self.params.get("weight_decay", 1e-3)),
            "max_grad_norm": float(max_grad_norm) if max_grad_norm else None,
        }

    def init_opt_state(self):
        return {"backbone": ft_optim.init_group(trainable_leaves(self.backbone_params)),
                "head": ft_optim.init_group(trainable_leaves(self.head_params))}

    def _resume(self, ckpt_dir) -> int:
        from pd_fusion_torch.utils.checkpoint import load_checkpoint

        state = load_checkpoint(ckpt_dir)
        if state is None:
            return 0
        move = lambda tree: _map_tensors(tree, lambda t: t.to(self.device))  # noqa: E731
        self.backbone_params = move(state["backbone"])
        self.head_params = move(state["head"])
        self.opt_state = {g: {"count": int(s["count"]), "mu": move(s["mu"]), "nu": move(s["nu"])}
                          for g, s in state["opt_state"].items()}
        return int(state["epoch"]) + 1

    def train(self, bags, y, val_data=None, dropout_keep_fn=None):
        """``dropout_keep_fn(B, L, H)``, when given, supplies each step's head
        dropout keeps (bool [B, L, H]) in place of the torch generator."""
        from pd_fusion_torch.training.callbacks import MetricEarlyStopping
        from pd_fusion_torch.utils.checkpoint import save_checkpoint

        y = np.asarray(y, np.float32)
        epochs = int(self.params.get("epochs", 20))
        patience = int(self.params.get("early_stopping_patience", 0))
        hyper = self._hyper(self._resolve_pos_weight(y))
        rng = self._rng()
        generator = fresh_generator(self.device)
        hidden = int(self.params.get("hidden_dim", 256))
        self.opt_state = self.init_opt_state()

        ckpt_dir = self.params.get("checkpoint_dir")
        ckpt_every = int(self.params.get("checkpoint_every", 0))
        start_epoch = self._resume(ckpt_dir) if ckpt_dir else 0

        # initial_best -1.0: epochs whose AUC fails (-1.0) never improve, so a
        # never-valid val set keeps the stop-time params
        stopper = MetricEarlyStopping(patience=patience, initial_best=-1.0)
        for epoch in range(start_epoch, epochs):
            gate = 1.0 if epoch >= self.freeze_backbone_epochs else 0.0
            with closing(_prepared_ahead(self._epoch_steps(bags, y, rng))) as steps:
                for arrays in steps:
                    batch = {k: self._on_device(a) for k, a in arrays.items()}
                    if dropout_keep_fn is not None:
                        bs, L_i = arrays["bag_mask"].shape
                        batch["keep"] = self._t(dropout_keep_fn(bs, L_i, hidden), bool)
                    profiling.count("trainer:steps")
                    self.backbone_params, self.head_params, _ = ft_step(
                        self.backbone_params, self.head_params, self.opt_state, batch, gate,
                        hyper, generator)

            if ckpt_dir and ckpt_every and (epoch + 1) % ckpt_every == 0:
                save_checkpoint(ckpt_dir, {"backbone": self.backbone_params,
                                           "head": self.head_params,
                                           "opt_state": self.opt_state, "epoch": epoch},
                                step=epoch)

            if val_data is not None and patience > 0:
                val_bags, y_val = val_data
                auc = val_auc(y_val, self.predict_proba(val_bags))
                if stopper.update(auc, lambda: (_clone(self.backbone_params),
                                                _clone(self.head_params))):
                    break

        if stopper.best_state is not None:
            self.backbone_params, self.head_params = stopper.best_state

    def _predict_chunk(self, X, bag_mask):
        """One pass over a chunk of bags (span ``trainer:_predict_chunk``, the
        host's enqueue; counter ``trainer:passes``)."""
        profiling.count("trainer:passes")
        with profiling.span("trainer:_predict_chunk"):
            B, L = X.shape[:2]
            x = slices_to_imagenet_batch(X.reshape(B * L, *X.shape[2:]), self.input_size,
                                         self._t(self.mean), self._t(self.std))
            emb = _family(self.backbone_name).apply(self.backbone_params, x,
                                                    self.backbone_name).reshape(B, L, -1)
            return torch.sigmoid(mil_apply(self.head_params, emb, bag_mask, gated=self.gated))

    @torch.no_grad()
    def predict_proba(self, bags, masks=None):
        mri_mask = masks.get("mri") if isinstance(masks, dict) else None
        n = len(bags)
        out = np.full(n, self.missing_prob, np.float32)
        present = [i for i in range(n)
                   if bags[i] is not None and not (mri_mask is not None and mri_mask[i] == 0)]
        if not present:
            return out
        rng = self._rng()
        chunks = [present[i: i + self.bag_batch_size]
                  for i in range(0, len(present), self.bag_batch_size)]
        passes = max(self.tta_inference, 1)
        with closing(_prepared_ahead(self._predict_passes(bags, chunks, passes, rng))) as items:
            for k, (padded, draw) in enumerate(items):
                chunk = np.asarray(chunks[k // passes])
                if padded is not None:
                    Xt, mt = self._t(padded[0]), self._t(padded[1])
                    acc = np.zeros(len(chunk), np.float32)
                if draw is None:
                    out[chunk] = self._readback(self._predict_chunk(Xt, mt))
                    continue
                draw = [self._on_device(a) for a in draw]
                acc += self._readback(self._predict_chunk(augment(Xt, *draw), mt))
                if k % passes == passes - 1:
                    out[chunk] = acc / self.tta_inference
        return out

    def _predict_passes(self, bags, chunks, passes, rng):
        """``predict_proba``'s passes as host arrays: per chunk its padded
        slices and mask with the first pass, and each pass's augmentation
        draws where there is more than one pass. Yields the number of
        passes first (``_prepared_ahead``)."""
        yield len(chunks) * passes
        for chunk in chunks:
            X, bag_mask = self._pad_batch([self._load_bag_slices(bags[i]) for i in chunk])
            if passes == 1:
                yield (X, bag_mask), None
                continue
            B, L, h, w = X.shape
            for p in range(passes):
                yield (X, bag_mask) if p == 0 else None, self._aug_params(B, L, h, w, rng, True)

    def save(self, path):
        save_pickle({"kind": KIND, "params": self.params,
                     "backbone": params_to_jax(self.backbone_params),
                     "attn": mil_nn.params_to_numpy(self.head_params)}, path)

    @classmethod
    def load(cls, path, params=None, device=None):
        state = load_pickle(path)
        inst = cls(state["params"], device=device)
        inst.backbone_params = params_to(params_from_jax(state["backbone"]), device=inst.device)
        inst.head_params = mil_nn.params_from_jax(state["attn"], device=inst.device)
        return inst
