"""Drive ``train_swin``: the ``train`` drive's calls on a Swin backbone.

Everything but the backbone is the ``train`` drive's: one
``MilAttentionFineTuneModel.train`` call after another on one model, the
set-up's call and the window's last checked over their first
``checked_steps`` steps, the same draws, head, numbers and limits'
meaning. The backbone's table is the configuration's ``architecture``
block (``reference/swin.py``'s ``arch_from``); its weights are made from
the seed as the official init makes them (``backbone``) under the official
state_dict's names, which are also the program's tree's paths; the
reference is ``reference/mil_ft_swin.py``. The backbone has no running
statistics, so every compared leaf is a trainable one.
"""
import math
from typing import Dict

import numpy as np
import torch

from benchmark import flops_swin
from benchmark.drives.train import HEAD_NAMES, Train
from benchmark.harness import draws, weights
from benchmark.harness.drive import (BAGS_STREAM, WEIGHTS_STREAM, Drive, dev, host, precision,
                                     torch_generator)
from benchmark.reference import mil_ft_swin, swin

INIT_STD = 0.02


def backbone(a: swin.Arch, size: int, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The official init from the seed, in two large draws: linears' weights
    and bias tables normal with std 0.02 (timm's ``trunc_normal_`` cuts at
    +-2, 100 std away: nothing), their biases 0, LayerNorms at identity; the
    patch embedding's convolution uniform in +-1/sqrt(fan_in), weight and
    bias (torch's default, which the official init leaves)."""
    shapes = swin.param_shapes(a, size)
    normal = [k for k in shapes if k.endswith("bias_table") or (
        k.endswith(".weight") and ".norm" not in k and not k.startswith(("patch_embed", "norm")))]
    embed = ["patch_embed.proj.weight", "patch_embed.proj.bias"]
    sizes = [math.prod(shapes[k]) for k in normal]
    out = dict(zip(normal, (t.view(shapes[k]) for k, t in zip(normal, torch.split(
        torch.randn(sum(sizes), generator=gen, device=device) * INIT_STD, sizes)))))
    sizes = [math.prod(shapes[k]) for k in embed]
    bound = 1.0 / math.sqrt(math.prod(shapes[embed[0]][1:]))
    flat = (torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0) * bound
    out.update(zip(embed, (t.view(shapes[k]) for k, t in zip(embed, torch.split(flat, sizes)))))
    for k, shape in shapes.items():
        if k not in out:
            fill = torch.ones if k.endswith(".weight") else torch.zeros
            out[k] = fill(shape, device=device)
    return {k: out[k] for k in shapes}


def to_program(named: Dict[str, torch.Tensor]) -> Dict:
    """Flat official names -> the program's nested tree (a numeric part of
    a name indexes a list), without copies."""
    tree: Dict = {}
    for name, t in named.items():
        node, parts = tree, name.split(".")
        for part, nxt in zip(parts[:-1], parts[1:]):
            child = [] if nxt.isdigit() else {}
            if isinstance(node, list):
                i = int(part)
                node.extend([None] * (i + 1 - len(node)))
                node[i] = child if node[i] is None else node[i]
                node = node[i]
            else:
                node = node.setdefault(part, child)
        node[parts[-1]] = t
    return tree


def from_program(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The program's nested tree -> flat official names."""
    if isinstance(tree, (list, tuple)):
        tree = dict(enumerate(tree))
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    return {k: v for key, t in tree.items() for k, v in from_program(t, f"{prefix}{key}.").items()}


class TrainSwin(Train):
    def __init__(self, cell, seed, device):
        Drive.__init__(self, cell, seed, device)
        self.sw = swin.arch_from(cell.config["architecture"])
        self.steps_per_call = max(1, math.ceil(self.n_bags / self.bs))
        self.work_per_call = self.steps_per_call * self.bs * self.L  # slices
        self.flops_per_call = self.steps_per_call * flops_swin.train_step(
            self.sw, self.size, self.bs, self.L, self.H, self.A)
        self.n_checked = int(cell.mix["checked_steps"])
        self.dropout = float(self.p["dropout"])
        if not (self.p["train_aug"] and self.p["balanced_batches"]):
            raise ValueError("the reference replays augmented, class-balanced batches only")
        self.rec: Dict = {}

    def make_inputs(self):
        gen = torch_generator(self.seed, BAGS_STREAM, self.device)
        x = torch.rand(self.n_bags, self.L, self.h, self.w, generator=gen, device=self.device)
        self.bags = list(x.cpu().numpy())
        self.y = (np.arange(self.n_bags) < int(self.cell.mix["positive_bags"])).astype(np.float32)
        gen = torch_generator(self.seed, WEIGHTS_STREAM, self.device)
        bp = backbone(self.sw, self.size, gen, self.device)
        hp = weights.head(swin.emb_dim(self.sw), self.H, self.A, gen, self.device)
        return bp, hp

    def build_model(self, bp, hp):
        from pd_fusion_torch.models import mil_attention_finetune as mft
        from pd_fusion_torch.nn import swin as program_swin

        a = program_swin.ARCHS[self.arch]
        if (a.patch, a.embed_dim, a.depths, a.heads, a.window, a.mlp_ratio) != (
                self.sw.patch, self.sw.embed_dim, self.sw.depths, self.sw.heads, self.sw.window,
                self.sw.mlp_ratio):
            raise ValueError(f"the program's {self.arch} is not the configuration's: {a}")
        self.mft = mft
        self.rngs = draws.CallRngs(self.seed)
        self.model = mft.MilAttentionFineTuneModel(dict(self.p), device=self.device,
                                                   make_rng=self.rngs)
        self.model.backbone_params = to_program(bp)
        self.model.head_params = weights.to_program_head(hp)

    def _flat(self, backbone, head) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in {
            **from_program(backbone), **weights.from_program_head(head)}.items()}

    def _observe(self):
        """Wrap the program's ``ft_step`` as ``train``'s drive does, with the
        leaves' order of the program's Swin tree."""
        mft, n = self.mft, self.n_checked
        self._step = step = mft.ft_step
        self.order = (mft.trainable_leaves(to_program({k: k for k in swin.param_shapes(
            self.sw, self.size)})), mft.trainable_leaves(weights.to_program_head(
                {k: k for k in HEAD_NAMES})))

        def observed(*args, **kwargs):
            out = step(*args, **kwargs)
            rec = self.rec
            if len(rec["loss"]) < n:
                rec["loss"].append(out[2])
                if len(rec["loss"]) == 1:
                    rec["mu"] = {g: [t.detach().clone() for t in s["mu"]]
                                 for g, s in self.model.opt_state.items()}
                if len(rec["loss"]) == n:
                    rec["after"] = self._flat(out[0], out[1])
            return out

        mft.ft_step = observed

    def reference(self, rec: Dict, tf32: bool = False, half: bool = False):
        bp, hp = dev(rec["start"][0], self.device), dev(rec["start"][1], self.device)
        with precision(tf32):
            steps = mil_ft_swin.train_steps(
                bp, hp, self.batches(rec["call"], self.n_checked, half), self.hy, self.sw)
        return [{"loss": float(s["loss"]), "grads": host(s["grads"]), "taken": host(s["taken"]),
                 "after": {**host(s["backbone"]), **host(s["head"])}} for s in steps]


DRIVE = TrainSwin
